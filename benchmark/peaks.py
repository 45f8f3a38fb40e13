"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set below
700 W reaches less; every run prints its card's power limit."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
         "float16": 989e12, "fp8": 1979e12, "int8": 1979e12}
# the rate model FLOP utilisation is stated against: the configurations
# compute their products in bfloat16
MFU_PEAK = FLOPS["bfloat16"]

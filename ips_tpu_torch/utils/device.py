"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The port runs on the card unless the caller asks for another device.

    ``None`` means ``cuda``; without a CUDA device that raises instead of
    falling back to the CPU, so a CPU run is always an explicit request.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def fp32_matmuls() -> None:
    """Full-fp32 products in cuBLAS and cuDNN: TF32 off for both.

    PyTorch's default leaves ``cudnn.allow_tf32`` on, so an fp32 conv
    would round its inputs to TF32's 10-bit mantissa. Every command-line
    entry point of the port calls this first; library code does not, so
    that a caller's own setting stands."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

"""Serving export: the Predictor's pipeline as a ``torch.export`` program
(counterpart of ips_tpu/export.py).

The whole selection + aggregation + heads pipeline is traced once at a
fixed (B, N) with ``torch.export.export``; the trained weights become the
program's state, and ``torch.export.save`` writes one file. A serving
process loads it with :meth:`ExportedPredictor.load` and calls it without
the model code, the config or the checkpoint:

    # export (after training); --device cpu exports a CPU program
    python -m ips_tpu_torch.export --config config/mnist_config.yml \\
        --checkpoint weights.pt --output model.pt2 --batch 16 --selftest

    # serve
    import ips_tpu_torch.ops.score_kernel          # registers the op
    from ips_tpu_torch.export import ExportedPredictor
    model = ExportedPredictor.load("model.pt2")
    out = model.predict(patches)            # {task: probs, selected_idx}

Where this differs from ``jax.export``, whose artifact is self-contained
and may carry several platforms:

  * The program calls the scorer's operator ``ips_tpu_torch::score_logits``
    (``ops/score_kernel.py``), so the loading process must import
    ``ips_tpu_torch.ops.score_kernel`` first, which registers it; on the
    card the operator launches the ``nvcc``-built kernel
    (``csrc/score_logits.cu``, built at first use).
  * The program runs on the device it was exported for (``--device``, the
    card by default); its inputs are moved there.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ips_tpu_torch.config import Config, load_config
from ips_tpu_torch.utils.device import fp32_matmuls


def _input_specs(conf: Config, batch_size: int, n_patches: int,
                 device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Example (patches, mask) of the serving inputs: fp32 patches (B, N,
    ph, pw, C) or feature rows (B, N, F), and a (B, N) bool mask."""
    if conf.is_image:
        shape = (batch_size, n_patches, *conf.patch_size, conf.n_chan_in)
    else:
        shape = (batch_size, n_patches, conf.n_chan_in)
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.ones((batch_size, n_patches), dtype=torch.bool,
                       device=device))


class _Serve(nn.Module):
    """The Predictor's forward as a module that owns the model, so that
    export lifts the weights into the program's state."""

    def __init__(self, predictor):
        super().__init__()
        self.model = predictor.trainer.model
        self._predictor = predictor

    def forward(self, patches: torch.Tensor, mask: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        preds, mem_idx = self._predictor.forward(patches, mask)
        out = dict(preds)
        out["selected_idx"] = mem_idx
        return out


def export_predictor(predictor, batch_size: int,
                     n_patches: Optional[int] = None
                     ) -> torch.export.ExportedProgram:
    """Export a Predictor's pipeline at a fixed input shape, on the
    predictor's device. Save the result with ``torch.export.save``."""
    conf = predictor.conf
    n = n_patches or conf.N
    if not n:
        raise ValueError("n_patches is required when conf.N is 0 "
                         "(feature mode): pass the padded slide length")
    args = _input_specs(conf, batch_size, n, predictor.device)
    with torch.no_grad():
        program = torch.export.export(_Serve(predictor), args, strict=False)
    # the example inputs would be saved with the program: at the MNIST
    # width the zero patches alone are 144 MB
    program.example_inputs = None
    return program


class ExportedPredictor:
    """Serving wrapper over a loaded program (no model code)."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self._module = program.module()
        names = program.graph_signature.user_inputs
        vals = {n.name: n.meta["val"] for n in program.graph.nodes
                if n.op == "placeholder"}
        self._patches_spec = vals[names[0]]
        self.device = self._patches_spec.device

    @classmethod
    def load(cls, path: str) -> "ExportedPredictor":
        return cls(torch.export.load(path))

    @property
    def batch_size(self) -> int:
        return self._patches_spec.shape[0]

    @property
    def n_patches(self) -> int:
        return self._patches_spec.shape[1]

    def predict(self, patches: np.ndarray,
                mask: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        x = torch.as_tensor(np.ascontiguousarray(patches, np.float32))
        if tuple(x.shape) != tuple(self._patches_spec.shape):
            raise ValueError(
                f"exported for input {tuple(self._patches_spec.shape)}, got "
                f"{tuple(x.shape)} — re-export with matching --batch/"
                "--n-patches or pad the batch")
        m = (torch.as_tensor(np.asarray(mask, bool)) if mask is not None
             else torch.ones(x.shape[:2], dtype=torch.bool))
        with torch.no_grad():
            out = self._module(x.to(self.device), m.to(self.device))
        return {k: (v.cpu().numpy() if k == "selected_idx"
                    else v.float().cpu().numpy()) for k, v in out.items()}


def selftest(model: ExportedPredictor, predictor, seed: int = 0) -> bool:
    """The loaded program against the live predictor on seeded normal
    inputs: selected indices equal, probabilities within atol 1e-5 (the
    JAX package's selftest). Returns whether every output is bitwise
    equal."""
    rng = np.random.default_rng(seed)
    patches = rng.normal(0, 1, tuple(model._patches_spec.shape)).astype(
        np.float32)
    out, live = model.predict(patches), predictor.predict(patches)
    if set(out) != set(live):
        raise AssertionError(f"outputs {sorted(out)} != {sorted(live)}")
    np.testing.assert_array_equal(out["selected_idx"], live["selected_idx"])
    for k, v in out.items():
        np.testing.assert_allclose(v, live[k], rtol=0, atol=1e-5, err_msg=k)
    return all(np.array_equal(v, live[k]) for k, v in out.items())


def main(argv=None):
    fp32_matmuls()
    p = argparse.ArgumentParser(description="Export the IPS predictor "
                                "with torch.export")
    p.add_argument("--config", required=True,
                   help="YAML (needs pyyaml) or JSON config")
    p.add_argument("--checkpoint", required=True,
                   help="torch.save state dict or flat reference .npz")
    p.add_argument("--output", required=True)
    p.add_argument("--batch", type=int, required=True,
                   help="serving batch size (static shape)")
    p.add_argument("--n-patches", type=int, default=0,
                   help="patches per input (default: conf.N)")
    p.add_argument("--device", default="cuda",
                   help="device the program is exported for and runs on")
    p.add_argument("--selftest", action="store_true",
                   help="load the artifact and check it against the live "
                        "predictor on random inputs")
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)

    from ips_tpu_torch.infer import Predictor
    conf = load_config(a.config, a.overrides)
    predictor = Predictor(conf, checkpoint=a.checkpoint, device=a.device)
    program = export_predictor(predictor, a.batch, a.n_patches or None)
    torch.export.save(program, a.output)
    spec = _input_specs(conf, a.batch, a.n_patches or conf.N, "meta")[0]
    print(f"wrote {a.output} ({os.path.getsize(a.output) / 1e6:.1f} MB, "
          f"input {tuple(spec.shape)}, device {predictor.device})")
    if a.selftest:
        same = selftest(ExportedPredictor.load(a.output), predictor)
        print("selftest ok: selected_idx equal, probabilities within 1e-5 "
              "of the live predictor ("
              + ("bitwise equal" if same else "not bitwise equal") + ")")
    return program


if __name__ == "__main__":
    main()

"""Inference: load weights, classify megapixel inputs (counterpart of
ips_tpu/infer.py).

Deterministic pipeline: selection without shuffle, then the eval-mode
forward. Runs on the card unless ``device='cpu'`` (``--device cpu``).

    python -m ips_tpu_torch.infer --config config/mnist_config.yml \\
        --checkpoint weights.pt --input images/*.png --output preds.json

``--checkpoint`` is a ``torch.save`` file of the port's state dict, or a
flat reference-named ``.npz`` from :mod:`ips_tpu_torch.weights` (the
reference's orbax checkpoints need JAX to read).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from ips_tpu_torch.config import Config, load_config
from ips_tpu_torch.train.steps import IPSTrainer
from ips_tpu_torch.utils.device import fp32_matmuls
from ips_tpu_torch.utils.profiling import span


class Predictor:
    """Deterministic IPS inference over one set of weights."""

    def __init__(self, conf: Config, checkpoint: Optional[str] = None,
                 trainer: Optional[IPSTrainer] = None,
                 device: Optional[Union[str, torch.device]] = None):
        # inference never shuffles: selection is deterministic
        self.conf = conf.replace(shuffle=False)
        if trainer is not None:
            device = trainer.device if device is None else device
        self.trainer = IPSTrainer(self.conf, device=device, init_opt=False)
        if trainer is not None:
            self.trainer.model.load_state_dict(trainer.model.state_dict())
        if checkpoint:
            load_checkpoint(self.trainer.model, checkpoint)
        self.device = self.trainer.device

    def forward(self, patches: torch.Tensor, mask: torch.Tensor):
        """(B, N, ...) patches and a (B, N) mask on the device ->
        ({task: probs}, (B, M) selected indices). The caller chooses the
        grad mode: ``predict`` runs it under inference mode, the export
        (``ips_tpu_torch/export.py``) traces it under ``no_grad``."""
        tr, model = self.trainer, self.trainer.model
        if tr._reuse_eval_emb():
            # the selection buffer's embeddings are what re-encoding the
            # survivors would recompute: skip the encoder pass
            _, mem_pos, mem_idx, mem_mask, mem_emb = tr._select_impl(
                patches, mask, return_emb=True)
            attn_mask = mem_mask if self.conf.mask_padding else None
            emb = mem_emb if mem_pos is None else mem_emb + mem_pos
            return model.predict(model.aggregate(emb, attn_mask)), mem_idx
        mem_patch, mem_pos, mem_idx, mem_mask = tr._select_impl(patches, mask)
        attn_mask = mem_mask if self.conf.mask_padding else None
        return model(mem_patch, mem_pos, attn_mask), mem_idx

    def predict(self, patches: np.ndarray,
                mask: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """patches (B, N, ...), image patches or feature rows, with an
        optional (B, N) validity mask -> {task: probs} + 'selected_idx'
        (B, M)."""
        with span("serve.request"):
            x = torch.as_tensor(np.ascontiguousarray(patches)).to(
                self.device)
            B, N = x.shape[:2]
            m = (torch.as_tensor(np.asarray(mask, bool)).to(self.device)
                 if mask is not None
                 else torch.ones((B, N), dtype=torch.bool,
                                 device=self.device))
            with torch.inference_mode():
                preds, mem_idx = self.forward(x, m)
            out = {k: v.float().cpu().numpy() for k, v in preds.items()}
            out["selected_idx"] = mem_idx.cpu().numpy()
            return out


def load_checkpoint(model: torch.nn.Module, path: str) -> None:
    """A flat reference-named ``.npz`` or a ``torch.save``d state dict."""
    if path.endswith(".npz"):
        from ips_tpu_torch.weights import load_flat
        load_flat(model, path)
    else:
        model.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True))


def _load_inputs(conf: Config, paths):
    """Image files or .npy patch arrays -> ((B, N, ph, pw, C), row_sources).

    A multi-sample .npy contributes several rows ("file.npy[k]").
    """
    from ips_tpu_torch.data.patchify import patchify
    batches, sources = [], []
    for p in paths:
        name = os.path.basename(p)
        if p.endswith(".npy"):
            arr = np.load(p)
            if arr.ndim == 4:            # (N, ph, pw, C) single image
                arr = arr[None]
            batches.append(arr.astype(np.float32))
            sources.extend(name if arr.shape[0] == 1 else f"{name}[{k}]"
                           for k in range(arr.shape[0]))
        else:
            from PIL import Image
            img = np.asarray(Image.open(p).convert(
                "L" if conf.n_chan_in == 1 else "RGB"), np.float32) / 255.0
            if img.ndim == 2:
                img = img[..., None]
            batches.append(patchify(img, conf.patch_size,
                                    conf.patch_stride)[None])
            sources.append(name)
    return np.concatenate(batches, axis=0), sources


def main(argv=None):
    fp32_matmuls()
    p = argparse.ArgumentParser(description="ips_tpu_torch inference")
    p.add_argument("--config", required=True,
                   help="YAML (needs pyyaml) or JSON config")
    p.add_argument("--checkpoint", required=True,
                   help="torch.save state dict, or flat reference .npz")
    p.add_argument("--input", nargs="+", required=True,
                   help="image files or .npy patch arrays (globs ok)")
    p.add_argument("--output", default="",
                   help="write predictions JSON here (default: stdout)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, which must exist)")
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)

    conf = load_config(a.config, a.overrides)
    paths = sorted(sum((glob.glob(x) for x in a.input), []))
    if not paths:
        raise FileNotFoundError(f"no inputs matched {a.input}")
    patches, row_sources = _load_inputs(conf, paths)

    predictor = Predictor(conf, checkpoint=a.checkpoint, device=a.device)
    preds = predictor.predict(patches)

    result = []
    for i, source in enumerate(row_sources):
        row = {"input": source}
        for task in conf.task_list:
            probs = preds[task.name][i]
            row[task.name] = {
                "probs": np.asarray(probs).round(5).tolist(),
                "pred": (int(np.argmax(probs))
                         if task.act_fn == "softmax"
                         else (np.asarray(probs) >= 0.5).astype(int).tolist()),
            }
        row["selected_patches"] = preds["selected_idx"][i].tolist()
        result.append(row)

    text = json.dumps(result, indent=2)
    if a.output:
        with open(a.output, "w") as f:
            f.write(text)
        print(f"wrote {a.output}")
    else:
        print(text)


if __name__ == "__main__":
    main()

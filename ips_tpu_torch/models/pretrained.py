"""Pretrained encoder weights: torchvision checkpoint -> ``.npz`` -> the
port's encoder (counterpart of ips_tpu/models/pretrained.py).

A local torchvision ResNet state dict is converted once to a flat
``.npz`` in the JAX package's names and layouts (conv kernels HWIO,
BatchNorm ``scale``/``bias`` in ``params`` and ``mean``/``var`` in
``batch_stats``), so that a file converted by either package loads in
both. :func:`load_encoder_npz` loads it into the port's
``ConvPatchEncoder``, or into an ``IPSModel`` with ``prefix='encoder/'``,
through the weight bridge's HWIO -> OIHW rules. Nothing is downloaded.

    python -m ips_tpu_torch.models.pretrained resnet50.pth weights.npz \
        --enc_type resnet50
    # training: set config `pretrained: true, pretrained_path: weights.npz`
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ips_tpu_torch.models.encoders import _STAGE_BLOCKS
from ips_tpu_torch.weights import _from_reference, _tensors

_STAGE_WIDTHS = (64, 128, 256, 512)


def torchvision_manifest(enc_type: str = "resnet18"
                         ) -> Dict[str, tuple]:
    """Exact key -> shape schema of a FULL torchvision ResNet state dict.

    Derived from the standard architecture, so that a real
    ``ResNet18_Weights.IMAGENET1K_V1`` / ``ResNet50`` checkpoint can be
    checked for complete coverage without torchvision. It includes the
    keys the converter ignores: ``fc.*``, which the truncated encoder
    drops, and BatchNorm's ``num_batches_tracked`` counters.
    """
    blocks = _STAGE_BLOCKS[enc_type]
    bottleneck = enc_type == "resnet50"
    exp = 4 if bottleneck else 1
    man: Dict[str, tuple] = {"conv1.weight": (64, 3, 7, 7)}

    def bn(name, c):
        man[f"{name}.weight"] = (c,)
        man[f"{name}.bias"] = (c,)
        man[f"{name}.running_mean"] = (c,)
        man[f"{name}.running_var"] = (c,)
        man[f"{name}.num_batches_tracked"] = ()

    bn("bn1", 64)
    c_in = 64
    for stage, (w, n_blocks) in enumerate(zip(_STAGE_WIDTHS, blocks), 1):
        for b in range(n_blocks):
            pre = f"layer{stage}.{b}"
            out = w * exp
            if bottleneck:
                man[f"{pre}.conv1.weight"] = (w, c_in, 1, 1)
                bn(f"{pre}.bn1", w)
                man[f"{pre}.conv2.weight"] = (w, w, 3, 3)
                bn(f"{pre}.bn2", w)
                man[f"{pre}.conv3.weight"] = (out, w, 1, 1)
                bn(f"{pre}.bn3", out)
            else:
                man[f"{pre}.conv1.weight"] = (w, c_in, 3, 3)
                bn(f"{pre}.bn1", w)
                man[f"{pre}.conv2.weight"] = (w, w, 3, 3)
                bn(f"{pre}.bn2", w)
            if b == 0 and c_in != out:
                man[f"{pre}.downsample.0.weight"] = (out, c_in, 1, 1)
                bn(f"{pre}.downsample.1", out)
            c_in = out
    man["fc.weight"] = (1000, 512 * exp)
    man["fc.bias"] = (1000,)
    return man


def verify_torchvision_state_dict(state_dict, enc_type: str = "resnet18",
                                  allow_missing: bool = False) -> None:
    """Check a state dict against the full torchvision key+shape schema.

    Raises ValueError listing every missing key (unless
    ``allow_missing``, for deliberately truncated checkpoints), every
    unexpected key, and every shape mismatch — loud and complete, so a
    wrong/renamed checkpoint fails at conversion, not as silently-kept
    random init at train time.
    """
    man = torchvision_manifest(enc_type)
    shapes = {k: tuple(getattr(v, "shape", ())) for k, v in
              state_dict.items()}
    problems = []
    if not allow_missing:
        missing = sorted(k for k in man if k not in shapes)
        if missing:
            problems.append(f"missing {len(missing)} keys: "
                            + ", ".join(missing[:8])
                            + ("..." if len(missing) > 8 else ""))
    unexpected = sorted(k for k in shapes if k not in man)
    if unexpected:
        problems.append(f"unexpected {len(unexpected)} keys: "
                        + ", ".join(unexpected[:8])
                        + ("..." if len(unexpected) > 8 else ""))
    bad = [f"{k}: checkpoint {shapes[k]} vs torchvision {man[k]}"
           for k in sorted(shapes) if k in man and shapes[k] != man[k]]
    if bad:
        problems.append("shape mismatches: " + "; ".join(bad[:8])
                        + ("..." if len(bad) > 8 else ""))
    if problems:
        raise ValueError(
            f"state dict does not match the torchvision {enc_type} "
            "schema — " + " | ".join(problems))


def torch_resnet_to_flat(state_dict, enc_type: str = "resnet18",
                         verify: str = "truncated"
                         ) -> Dict[str, np.ndarray]:
    """torchvision ResNet state dict -> flat {reference name: array} npz
    payload, in the JAX package's names and layouts.

    Conv kernels transpose OIHW -> HWIO; BatchNorm maps to
    scale/bias (params) + mean/var (batch_stats).

    ``verify``: 'full' checks the complete torchvision schema (a real
    downloaded checkpoint must convert without code changes — every key
    present, none unexpected, all shapes right); 'truncated' allows
    missing keys but still rejects unknown keys and wrong shapes;
    'none' disables validation.
    """
    if verify not in ("full", "truncated", "none"):
        raise ValueError(f"verify must be full|truncated|none, got {verify}")
    if verify != "none":
        verify_torchvision_state_dict(state_dict, enc_type,
                                      allow_missing=verify == "truncated")
    def np_(t):
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                          else t)

    out: Dict[str, np.ndarray] = {}

    def put_conv(src: str, dst: str):
        w = np_(state_dict[src + ".weight"])
        out[f"params/{dst}/kernel"] = w.transpose(2, 3, 1, 0)

    def put_bn(src: str, dst: str):
        out[f"params/{dst}/scale"] = np_(state_dict[src + ".weight"])
        out[f"params/{dst}/bias"] = np_(state_dict[src + ".bias"])
        out[f"batch_stats/{dst}/mean"] = np_(state_dict[src + ".running_mean"])
        out[f"batch_stats/{dst}/var"] = np_(state_dict[src + ".running_var"])

    put_conv("conv1", "conv1")
    put_bn("bn1", "bn1")
    blocks = _STAGE_BLOCKS[enc_type]
    n_convs = 3 if enc_type == "resnet50" else 2
    for stage in range(4):
        for b in range(blocks[stage]):
            src = f"layer{stage + 1}.{b}"
            dst = f"layer{stage + 1}_block{b}"
            if src + ".conv1.weight" not in state_dict:
                # truncated checkpoint: the WHOLE block must be absent —
                # a half-present block converting silently would train
                # from half-random init
                leftover = [k for k in state_dict if k.startswith(src + ".")]
                if leftover:
                    raise ValueError(
                        f"block {src} is partially present (e.g. "
                        f"{leftover[0]}) — refusing a half-converted block")
                continue
            try:
                for c in range(1, n_convs + 1):
                    put_conv(f"{src}.conv{c}", f"{dst}/conv{c}")
                    put_bn(f"{src}.bn{c}", f"{dst}/bn{c}")
            except KeyError as e:
                raise ValueError(
                    f"block {src} is partially present (missing {e}) — "
                    "refusing a half-converted block") from e
            if src + ".downsample.0.weight" in state_dict:
                put_conv(f"{src}.downsample.0", f"{dst}/downsample_conv")
                put_bn(f"{src}.downsample.1", f"{dst}/downsample_bn")
    return out


def save_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    np.savez(path, **flat)


def seeded_state_dict(enc_type: str = "resnet50", seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    """A full torchvision-layout ResNet state dict of random values drawn
    from ``seed``, for runs without a checkpoint file: convs
    kaiming-normal (fan_out), BatchNorm scale U(0.5, 1), bias, running
    mean N(0, 0.05) and running variance U(0.5, 1.5), ``fc`` N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for key, shape in torchvision_manifest(enc_type).items():
        leaf = key.rpartition(".")[2]
        if leaf == "num_batches_tracked":
            sd[key] = np.array(0, np.int64)
        elif len(shape) == 4:
            std = np.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            sd[key] = rng.normal(0.0, std, shape).astype(np.float32)
        elif key.startswith("fc."):
            sd[key] = rng.normal(0.0, 0.01, shape).astype(np.float32)
        elif leaf == "weight":
            sd[key] = rng.uniform(0.5, 1.0, shape).astype(np.float32)
        elif leaf == "running_var":
            sd[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            sd[key] = rng.normal(0.0, 0.05, shape).astype(np.float32)
    return sd


@torch.no_grad()
def load_encoder_npz(path: str, model: nn.Module, prefix: str = "",
                     on_mismatch: str = "raise", skip_keys=(),
                     expect_cover: bool = False) -> nn.Module:
    """Load a converted ``.npz`` into ``model`` in place and return it.

    ``model``: the port's ``ConvPatchEncoder``, or an ``IPSModel`` with
    ``prefix='encoder/'``. Keys of the npz with no counterpart in the
    model are ignored; the model's tensors the npz does not hold keep
    their values.

    ``skip_keys``: npz keys (e.g. ``params/conv1/kernel``) deliberately
    left at their initial values: a stem rebuilt for another number of
    input channels is the one legitimate case. Any other shape mismatch
    raises; ``on_mismatch='skip'`` turns them all into silent skips.

    ``expect_cover``: every tensor of the model under ``prefix`` (both
    collections, less ``skip_keys``) must have been loaded, so that a
    checkpoint that matches only in part fails instead of training from
    half-random weights.
    """
    if on_mismatch not in ("raise", "skip"):
        raise ValueError(f"on_mismatch must be raise|skip, got {on_mismatch}")
    skip_keys = set(skip_keys)
    with np.load(path) as z:
        flat_npz = {k: z[k] for k in z.files}
    targets = {ref_key: (key, layout, t)
               for key, ref_key, layout, t in _tensors(model)}
    loaded, skipped = set(), set()
    for npz_key, val in flat_npz.items():
        col, _, rest = npz_key.partition("/")
        target = f"{col}/{prefix}{rest}"
        if target not in targets:
            continue
        if npz_key in skip_keys:
            skipped.add(target)
            continue
        key, layout, tensor = targets[target]
        want = tuple(tensor.shape)
        if layout == "conv":
            want = tuple(tensor.permute(2, 3, 1, 0).shape)
        elif layout == "dense":
            want = want[::-1]
        if tuple(val.shape) != want:
            if on_mismatch == "skip":
                continue
            raise ValueError(
                f"shape mismatch for {target}: checkpoint {val.shape} vs "
                f"model {want} (if this reinit is intentional, list the "
                "key in skip_keys)")
        tensor.copy_(_from_reference({target: val}, key, target, layout,
                                     tensor))
        loaded.add(target)
    if not loaded:
        raise ValueError(f"no keys from {path} matched the model")
    if expect_cover:
        want_keys = {k for k in targets
                     if k.partition("/")[2].startswith(prefix)}
        uncovered = sorted(want_keys - loaded - skipped)
        if uncovered:
            raise ValueError(
                f"{len(uncovered)} encoder variables not covered by "
                f"{path}: " + ", ".join(uncovered[:8])
                + ("..." if len(uncovered) > 8 else ""))
    return model


def main(argv=None):
    import argparse

    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    p = argparse.ArgumentParser(
        description="Convert a torchvision ResNet checkpoint to npz")
    p.add_argument("--enc_type", default="resnet18",
                   choices=["resnet18", "resnet50"])
    p.add_argument("--schema", default="full",
                   choices=["full", "truncated", "none"],
                   help="checkpoint validation: 'full' requires the exact "
                        "torchvision key+shape schema (default; a real "
                        "ImageNet checkpoint must pass), 'truncated' "
                        "allows missing stages, 'none' skips validation")
    p.add_argument("torch_ckpt", help=".pth state dict (local file)")
    p.add_argument("out_npz")
    a = p.parse_args(argv)
    sd = torch.load(a.torch_ckpt, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    flat = torch_resnet_to_flat(sd, a.enc_type, verify=a.schema)
    save_npz(a.out_npz, flat)
    print(f"wrote {len(flat)} arrays to {a.out_npz}")


if __name__ == "__main__":
    main()

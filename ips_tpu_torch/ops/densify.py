"""Sparse densification on the tensor's device: (indices, values) -> patch
tensor (counterpart of ips_tpu/ops/densify.py).

With ``sparse_input`` the loader ships each megapixel-MNIST image as its
sparse pixels (~0.3% dense, O(nnz) host-to-device bytes instead of
O(H*W)), and this scatter writes them into (B, N, ph, pw, C) patches where
the step runs. Requires exact tiling (patch_stride == patch_size), which
is the shipped MNIST configuration.
"""

from __future__ import annotations

import torch


def densify_patches(flat_idx: torch.Tensor, values: torch.Tensor,
                    img_hw: tuple, patch_size: tuple, n_chan: int = 1,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, nnz) flat indices over (H, W, C) + (B, nnz) values
    -> (B, N, ph, pw, C) in ``out_dtype``, on the inputs' device.

    A scatter-add into zeros, in ``out_dtype`` as the JAX package adds.
    Padded entries must carry value 0 (their index may be any valid
    position). Only they can collide with another entry, since a real
    pixel appears once, and adding 0 changes nothing: the result is exact
    whatever order the device's atomics take.
    """
    H, W = img_hw
    ph, pw = patch_size
    if H % ph or W % pw:
        raise ValueError("densify_patches requires exact tiling")
    nw = W // pw
    n_patches = (H // ph) * nw

    B, nnz = flat_idx.shape
    idx = flat_idx.long()
    c = idx % n_chan
    pix = idx // n_chan
    w = pix % W
    h = pix // W
    patch = (h // ph) * nw + (w // pw)
    row = torch.arange(B, device=idx.device)[:, None] * n_patches
    dst = (((row + patch) * ph + h % ph) * pw + w % pw) * n_chan + c

    out = torch.zeros(B * n_patches * ph * pw * n_chan, dtype=out_dtype,
                      device=idx.device)
    out.scatter_add_(0, dst.reshape(-1), values.to(out_dtype).reshape(-1))
    return out.view(B, n_patches, ph, pw, n_chan)

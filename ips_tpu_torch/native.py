"""Host-side patch ops in numpy (counterpart of ips_tpu/native/__init__.py).

The JAX package runs ``densify_patchify``, ``patchify_dense`` and
``gather_patches`` through a C++ library built with g++ at first use,
with numpy as the fallback; both give the same values
(tests/test_native.py). Here they are the numpy versions only. The C++
library is a later item (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ips_tpu_torch.data.patchify import patchify


def densify_patchify(indices: np.ndarray, values: np.ndarray,
                     img_shape: Tuple[int, int, int],
                     patch_size: Tuple[int, int],
                     patch_stride: Tuple[int, int]) -> np.ndarray:
    """Sparse flat (indices, values) over (H, W, C) -> (n, ph, pw, C)
    float32 patches."""
    H, W, C = img_shape
    img = np.zeros(H * W * C, np.float32)
    img[np.asarray(indices)] = values
    return patchify(img.reshape(H, W, C), patch_size, patch_stride)


def patchify_dense(img: np.ndarray, patch_size: Tuple[int, int],
                   patch_stride: Tuple[int, int]) -> np.ndarray:
    """Dense (H, W, C) -> (n, ph, pw, C)."""
    return patchify(img, patch_size, patch_stride)


def gather_patches(src: np.ndarray, idx: np.ndarray,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """out[b, k] = src[b, idx[b, k]]; src (B, N, ...), idx (B, K). With
    ``out`` (B, K, ...) of src's dtype, the rows are written there (e.g.
    into pinned memory) instead of into a new array."""
    if out is None:
        return src[np.arange(src.shape[0])[:, None], idx]
    for b in range(src.shape[0]):
        np.take(src[b], idx[b], axis=0, out=out[b])
    return out

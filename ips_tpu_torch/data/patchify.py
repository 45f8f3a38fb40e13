"""Host-side patch extraction (copy of ips_tpu/data/patchify.py).

Zero-copy numpy stride trick producing (n_patches, ph, pw, C) patches in
row-major patch order, the order of torch's double ``Tensor.unfold``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def patchify(img: np.ndarray, patch_size: Tuple[int, int],
             patch_stride: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) -> (n_patches, ph, pw, C), row-major patch order."""
    H, W, C = img.shape
    ph, pw = patch_size
    sh, sw = patch_stride
    nh = (H - ph) // sh + 1
    nw = (W - pw) // sw + 1
    s0, s1, s2 = img.strides
    patches = np.lib.stride_tricks.as_strided(
        img,
        shape=(nh, nw, ph, pw, C),
        strides=(s0 * sh, s1 * sw, s0, s1, s2),
        writeable=False,
    )
    return np.ascontiguousarray(patches.reshape(nh * nw, ph, pw, C))

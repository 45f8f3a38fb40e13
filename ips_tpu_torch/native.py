"""Host-side patch ops (counterpart of ips_tpu/native/__init__.py).

``densify_patchify``, ``patchify_dense`` and ``gather_patches`` run on
float32 arrays through the port's C++ library, ``csrc/hostops.cpp``,
which g++ builds at first use (``utils/cuda_build.py``) and ctypes binds.
Other dtypes (camelyon_e2e's uint8 tiles, bf16 rows) take the numpy
versions, as the JAX package does. A failed build raises: unlike the
JAX package, nothing falls back to numpy quietly. The numpy versions stay
here as ``plain_*``; the two give the same values bitwise, since the C++
code only copies float32 values (tests/test_torch_native.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

from ips_tpu_torch.data.patchify import patchify
from ips_tpu_torch.utils.cuda_build import load_library

_LIBRARY = "hostops"


@functools.cache
def _bind() -> ctypes.CDLL:
    lib = load_library(_LIBRARY)
    p, i = ctypes.c_void_p, ctypes.c_int64
    lib.densify_patchify_f32.argtypes = [p, p] + [i] * 8 + [p]
    lib.densify_patchify_f32.restype = None
    lib.patchify_f32.argtypes = [p] + [i] * 7 + [p]
    lib.patchify_f32.restype = None
    lib.gather_patches_f32.argtypes = [p, p, i, i, i, i, p]
    lib.gather_patches_f32.restype = None
    return lib


def _grid(img_shape, patch_size, patch_stride) -> Tuple[int, int]:
    H, W = img_shape[:2]
    (ph, pw), (sh, sw) = patch_size, patch_stride
    if not (0 < ph <= H and 0 < pw <= W and sh > 0 and sw > 0):
        raise ValueError(f"patches {patch_size} / stride {patch_stride} do "
                         f"not fit an image of {tuple(img_shape)}")
    return (H - ph) // sh + 1, (W - pw) // sw + 1


# ------------------------------------------------------------ plain versions
def plain_densify_patchify(indices: np.ndarray, values: np.ndarray,
                           img_shape: Tuple[int, int, int],
                           patch_size: Tuple[int, int],
                           patch_stride: Tuple[int, int]) -> np.ndarray:
    """numpy version of :func:`densify_patchify`: densify, then patchify."""
    H, W, C = img_shape
    img = np.zeros(H * W * C, np.float32)
    img[np.asarray(indices)] = values
    return patchify(img.reshape(H, W, C), patch_size, patch_stride)


def plain_patchify_dense(img: np.ndarray, patch_size: Tuple[int, int],
                         patch_stride: Tuple[int, int]) -> np.ndarray:
    """numpy version of :func:`patchify_dense`."""
    return patchify(img, patch_size, patch_stride)


def plain_gather_patches(src: np.ndarray, idx: np.ndarray,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
    """numpy version of :func:`gather_patches`."""
    if out is None:
        return src[np.arange(src.shape[0])[:, None], idx]
    for b in range(src.shape[0]):
        np.take(src[b], idx[b], axis=0, out=out[b])
    return out


# ----------------------------------------------------------------- C++ path
def densify_patchify(indices: np.ndarray, values: np.ndarray,
                     img_shape: Tuple[int, int, int],
                     patch_size: Tuple[int, int],
                     patch_stride: Tuple[int, int]) -> np.ndarray:
    """Sparse flat (indices, values) over (H, W, C) -> (n, ph, pw, C)
    float32 patches, in O(nnz): the dense image is never made."""
    H, W, C = img_shape
    nh, nw = _grid(img_shape, patch_size, patch_stride)
    idx = np.ascontiguousarray(indices, np.int64)
    vals = np.ascontiguousarray(values, np.float32)
    if idx.ndim != 1 or idx.shape != vals.shape:
        raise ValueError(f"indices {idx.shape} and values {vals.shape} must "
                         "be 1-d of one length")
    if idx.size and not (0 <= idx.min() and idx.max() < H * W * C):
        raise IndexError(f"pixel index out of range for {tuple(img_shape)}")
    out = np.zeros((nh * nw,) + tuple(patch_size) + (C,), np.float32)
    _bind().densify_patchify_f32(idx.ctypes.data, vals.ctypes.data,
                                 idx.size, H, W, C, *patch_size,
                                 *patch_stride, out.ctypes.data)
    return out


def patchify_dense(img: np.ndarray, patch_size: Tuple[int, int],
                   patch_stride: Tuple[int, int]) -> np.ndarray:
    """Dense (H, W, C) -> (n, ph, pw, C)."""
    if img.dtype != np.float32:
        return plain_patchify_dense(img, patch_size, patch_stride)
    img = np.ascontiguousarray(img)
    H, W, C = img.shape
    nh, nw = _grid(img.shape, patch_size, patch_stride)
    out = np.empty((nh * nw,) + tuple(patch_size) + (C,), np.float32)
    _bind().patchify_f32(img.ctypes.data, H, W, C, *patch_size,
                         *patch_stride, out.ctypes.data)
    return out


def gather_patches(src: np.ndarray, idx: np.ndarray,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """out[b, k] = src[b, idx[b, k]]; src (B, N, ...), idx (B, K). With
    ``out`` (B, K, ...) of src's dtype, the rows are written there (e.g.
    into pinned memory) instead of into a new array; on the float32 path
    the C++ gather writes there directly."""
    if src.dtype != np.float32:
        return plain_gather_patches(src, idx, out)
    src = np.ascontiguousarray(src)
    B, N = src.shape[:2]
    idx32 = np.ascontiguousarray(idx, np.int32)
    if idx32.ndim != 2 or idx32.shape[0] != B:
        raise ValueError(f"idx {idx32.shape} must be (B={B}, K)")
    if idx32.size and not (0 <= idx32.min() and idx32.max() < N):
        raise IndexError(f"patch index out of range for N={N}")
    K = idx32.shape[1]
    shape = (B, K) + src.shape[2:]
    if out is None:
        out = np.empty(shape, np.float32)
    elif (out.shape != shape or out.dtype != np.float32
          or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writeable C-contiguous float32 "
                         f"array of {shape}, got {out.dtype} {out.shape}")
    elems = int(np.prod(src.shape[2:]))
    _bind().gather_patches_f32(src.ctypes.data, idx32.ctypes.data, B, N, K,
                               elems, out.ctypes.data)
    return out

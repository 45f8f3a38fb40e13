"""The port's C++ host ops (csrc/hostops.cpp via ips_tpu_torch.native)
against ips_tpu.native and the port's own numpy versions.

Every function only copies float32 values, so each comparison is
bitwise (tolerance 0).
"""

import os

import numpy as np
import pytest
import torch

from ips_tpu import native as jn
from ips_tpu_torch import native as tn
from ips_tpu_torch.utils import cuda_build

DENSIFY_CASES = [
    (60, 40, 1, (20, 20), (20, 20)),      # exact tiling
    (60, 40, 1, (20, 20), (10, 10)),      # 50% overlap
    (30, 30, 3, (10, 10), (10, 10)),      # multi-channel
    (64, 64, 1, (16, 16), (12, 12)),      # non-divisible stride
    (150, 150, 1, (50, 50), (50, 50)),    # megapixel MNIST's patches
]


def _sparse(rng, H, W, C, nnz):
    idx = rng.choice(H * W * C, size=nnz, replace=False).astype(np.int64)
    return idx, rng.random(nnz).astype(np.float32)


def test_library_builds():
    path, _ = cuda_build.build_library("hostops")
    assert os.path.exists(path) and os.path.basename(path).startswith(
        "hostops-")
    assert tn._bind().densify_patchify_f32 is not None


@pytest.mark.parametrize("H,W,C,ps,st", DENSIFY_CASES)
def test_densify_patchify_matches_jax(H, W, C, ps, st):
    idx, vals = _sparse(np.random.default_rng(H + W + C), H, W, C, 200)
    got = tn.densify_patchify(idx, vals, (H, W, C), ps, st)
    np.testing.assert_array_equal(
        got, jn.densify_patchify(idx, vals, (H, W, C), ps, st))
    np.testing.assert_array_equal(
        got, tn.plain_densify_patchify(idx, vals, (H, W, C), ps, st))
    assert got.dtype == np.float32


def test_densify_patchify_empty_and_out_of_range():
    got = tn.densify_patchify(np.zeros(0, np.int64), np.zeros(0, np.float32),
                              (20, 20, 1), (10, 10), (10, 10))
    assert got.shape == (4, 10, 10, 1) and not got.any()
    np.testing.assert_array_equal(got, jn.densify_patchify(
        np.zeros(0, np.int64), np.zeros(0, np.float32), (20, 20, 1),
        (10, 10), (10, 10)))
    with pytest.raises(IndexError):
        tn.densify_patchify(np.array([400]), np.ones(1, np.float32),
                            (20, 20, 1), (10, 10), (10, 10))


@pytest.mark.parametrize("shape,ps,st", [
    ((50, 70, 3), (10, 10), (10, 10)), ((50, 70, 3), (20, 14), (10, 7)),
    ((150, 150, 1), (50, 50), (50, 50))])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_patchify_dense_matches_jax(shape, ps, st, dtype):
    img = (np.random.default_rng(1).random(shape) * 255).astype(dtype)
    got = tn.patchify_dense(img, ps, st)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, jn.patchify_dense(img, ps, st))
    np.testing.assert_array_equal(got, tn.plain_patchify_dense(img, ps, st))


@pytest.mark.parametrize("shape", [(3, 40, 8, 8, 1), (2, 30, 16),
                                   (2, 25, 6, 6, 3)],
                         ids=["patches", "features", "rgb"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("with_out", [False, True], ids=["new", "out"])
def test_gather_patches_matches_jax(shape, dtype, with_out):
    rng = np.random.default_rng(2)
    src = (rng.random(shape) * 255).astype(dtype)
    idx = rng.integers(0, shape[1], (shape[0], 7)).astype(np.int32)
    want = jn.gather_patches(src, idx)
    np.testing.assert_array_equal(want, tn.plain_gather_patches(src, idx))
    if with_out:
        # pinned host memory where the streaming selector stages chunks
        # (plain memory here: pinning needs a card)
        buf = torch.empty((shape[0], 7) + shape[2:],
                          dtype=torch.from_numpy(src[:0]).dtype)
        out = buf.numpy()
        got = tn.gather_patches(src, idx, out=out)
        assert got is out
        np.testing.assert_array_equal(buf.numpy(), want)
    else:
        got = tn.gather_patches(src, idx)
    np.testing.assert_array_equal(got, want)


def test_gather_patches_rejects():
    src = np.zeros((2, 5, 3), np.float32)
    with pytest.raises(IndexError):
        tn.gather_patches(src, np.array([[0, 5], [1, 2]]))
    with pytest.raises(ValueError, match="out must be"):
        tn.gather_patches(src, np.zeros((2, 2), np.int32),
                          out=np.zeros((2, 2, 3), np.float64))
    with pytest.raises(ValueError, match="out must be"):
        tn.gather_patches(src, np.zeros((2, 2), np.int32),
                          out=np.zeros((2, 3, 2), np.float32).transpose(
                              0, 2, 1))


def test_mnist_dense_item_matches_jax(tmp_path):
    """The dense MegapixelMNIST item (host densify through the C++
    library) equals the JAX package's on one generated store."""
    from ips_tpu.config import config_from_dict as j_config
    from ips_tpu.data.mnist import MegapixelMNIST as JMNIST
    from ips_tpu.data.mnist import generate_megapixel_mnist
    from ips_tpu_torch.config import config_from_dict as t_config
    from ips_tpu_torch.data.mnist import MegapixelMNIST
    d = str(tmp_path)
    generate_megapixel_mnist(d, n_train=2, n_test=1, width=200, height=200,
                             n_noise=3, digit_source="sklearn")
    conf = dict(
        data_dir=d, patch_size=[50, 50], patch_stride=[50, 50], N=16, M=4,
        I=4, n_class=10, n_token=4, sparse_input=False,
        tasks={"task0": {"id": 0, "name": "majority", "act_fn": "softmax",
                         "metric": "accuracy"},
               "task1": {"id": 1, "name": "max", "act_fn": "softmax",
                         "metric": "accuracy"},
               "task2": {"id": 2, "name": "top", "act_fn": "softmax",
                         "metric": "accuracy"},
               "task3": {"id": 3, "name": "multi", "act_fn": "sigmoid",
                         "metric": "multilabel_accuracy"}})
    ours = MegapixelMNIST(t_config(dict(conf)), train=True)
    ref = JMNIST(j_config(dict(conf)), train=True)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["input"].shape == (16, 50, 50, 1)


def test_failed_build_raises_and_does_not_fall_back(monkeypatch, tmp_path):
    """With g++ pointed at a missing path (and nothing built yet), the
    first call raises, naming g++; no numpy result comes back."""
    monkeypatch.setattr(cuda_build, "GXX", str(tmp_path / "no" / "g++"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    tn._bind.cache_clear()
    cuda_build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            tn.densify_patchify(np.zeros(1, np.int64),
                                np.ones(1, np.float32), (20, 20, 1),
                                (10, 10), (10, 10))
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            tn.gather_patches(np.zeros((1, 3, 2), np.float32),
                              np.zeros((1, 1), np.int32))
        assert not os.path.exists(tmp_path / "build")
    finally:
        monkeypatch.undo()
        tn._bind.cache_clear()
        cuda_build.load_library.cache_clear()
    assert tn.densify_patchify(np.zeros(1, np.int64), np.ones(1, np.float32),
                               (20, 20, 1), (10, 10), (10, 10)).sum() == 1.0


def test_failed_compile_names_the_compiler(monkeypatch, tmp_path):
    """A source g++ refuses raises with g++'s own message."""
    (tmp_path / "broken.cpp").write_text("extern \"C\" int f( {\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on "
                       "csrc/broken.cpp"):
        cuda_build.build_library("broken")
    assert os.listdir(tmp_path / "build") == []

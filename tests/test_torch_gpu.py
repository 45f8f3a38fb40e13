"""Card-only tests of the port: the CUDA kernel against its plain version.

Skipped without a CUDA card. On the card (no JAX there):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from ips_tpu_torch.ops import score_kernel as sk

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(device, B, L, D, TH, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, L, D), np.float32))
    w = torch.from_numpy(0.1 * rng.standard_normal((D, TH), np.float32))
    return x.to(device, dtype), w.to(device, dtype)


# fp32 sums of the same products in another order: a few ulps of O(1)
@pytest.mark.parametrize("B,L,D,TH,dtype", [
    (16, 200, 128, 32, torch.float32), (16, 200, 128, 32, torch.bfloat16),
    (4, 1037, 128, 32, torch.float32), (1, 10000, 512, 8, torch.bfloat16),
    (1, 10000, 512, 8, torch.float32), (16, 42, 512, 8, torch.float32),
    (3, 33, 70, 64, torch.float32), (2, 1, 5, 1, torch.float32)])
def test_kernel_matches_plain(cuda, B, L, D, TH, dtype):
    x, w = _inputs(cuda, B, L, D, TH, dtype)
    before = sk.logits.launches
    got = sk.logits(x, w)
    assert sk.logits.launches == before + 1
    torch.testing.assert_close(got, sk.plain_logits(x, w), rtol=1e-5,
                               atol=1e-4)


# The redesigned kernel's paths: D in 16-byte vectors or element by element
# (37), one D chunk or several (fp32 chunks of 128, bf16 of 256 or 512),
# every TH rounding (1, 8, 12, 32, 64), a ragged last row tile (L=37, 203)
# and B = 1 or 16, in both types.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [16, 37, 128, 512])
@pytest.mark.parametrize("TH", [1, 8, 12, 32, 64])
@pytest.mark.parametrize("B,L", [(1, 37), (16, 203)])
def test_kernel_shapes(cuda, B, L, D, TH, dtype):
    x, w = _inputs(cuda, B, L, D, TH, dtype)
    before = sk.logits.launches
    got = sk.logits(x, w)
    assert sk.logits.launches == before + 1
    torch.testing.assert_close(got, sk.plain_logits(x, w), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_misaligned_x(cuda, dtype):
    # a contiguous x whose data starts off a 16-byte boundary takes the
    # element-by-element copies
    x, w = _inputs(cuda, 3, 45, 128, 32, dtype)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    xs = buf[1:].view(x.shape)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16 != 0
    torch.testing.assert_close(sk.logits(xs, w), sk.plain_logits(x, w),
                               rtol=1e-5, atol=1e-4)


def test_kernel_scores_masked(cuda):
    x, w = _inputs(cuda, 4, 200, 128, 32, torch.float32, seed=1)
    mask = torch.ones((4, 200), dtype=torch.bool, device=cuda)
    mask[0] = False
    mask[2, 150:] = False
    got = sk.scores(x, w, mask)
    torch.testing.assert_close(got, sk.fast_scores(x, w, mask), rtol=1e-4,
                               atol=1e-6)
    torch.testing.assert_close(got[0], torch.full_like(got[0], 1 / 200),
                               rtol=1e-6, atol=0.0)


def test_kernel_wrapper_rejects(cuda):
    x, w = _inputs(cuda, 2, 8, 16, 4, torch.float32)
    with pytest.raises(TypeError):
        sk.logits(x.half(), w.half())
    with pytest.raises(TypeError):
        sk.logits(x, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        sk.logits(x.transpose(0, 1), w)
    with pytest.raises(ValueError, match="out of range"):
        sk.logits(*_inputs(cuda, 2, 8, 16, 65, torch.float32))


def test_predictor_defaults_to_card_and_uses_kernel(cuda):
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.infer import Predictor
    conf = config_from_dict(dict(
        B=2, B_seq=2, n_class=10, n_chan_in=1, n_token=2, N=23, M=4, I=5,
        patch_size=[16, 16], patch_stride=[16, 16], use_pos=True, H=4,
        D=128, D_k=16, D_v=16, D_inner=256, compute_dtype="float32",
        tasks={"t": {"id": 0, "name": "t", "act_fn": "softmax",
                     "metric": "accuracy"}}))
    pred = Predictor(conf)
    assert pred.device.type == "cuda"
    x = np.random.default_rng(2).random((2, 23, 16, 16, 1), np.float32)
    before = sk.logits.launches
    out = pred.predict(x)
    assert sk.logits.launches - before == 4       # ceil((23 - 4) / 5)
    cpu = Predictor(conf, trainer=pred.trainer, device="cpu").predict(x)
    np.testing.assert_array_equal(out["selected_idx"], cpu["selected_idx"])
    np.testing.assert_allclose(out["t"], cpu["t"], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------- fused BasicBlock kernel
# Both sides accumulate the same exact bf16 products in fp32 (the kernel on
# tensor cores, in another order), then round h and the output to bf16: an
# fp32 difference can move a rounding by one bf16 ulp, 1.6e-2 for |y| < 4.
BLOCK_TOL = 1.6e-2


def _block_inputs(device, n, s, c, seed=0, block_diag=False):
    from ips_tpu_torch.ops.conv_block import kernel_params
    from ips_tpu_torch.scripts.probe_conv import make_block_params, pair_params
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(0.5 * rng.standard_normal((n, s, s, c), np.float32))
    if block_diag:
        p = pair_params(make_block_params(seed, c // 2), c // 2)
    else:
        p = make_block_params(seed, c)
    q = {k: v.to(device) for k, v in kernel_params(p).items()}
    return x.to(device, torch.bfloat16), q


@pytest.mark.parametrize("n,s,c,block_diag", [
    (1600, 13, 64, False), (800, 13, 128, True), (800, 13, 128, False),
    (37, 7, 64, False), (5, 16, 128, False), (3, 1, 32, False),
    (19, 11, 32, False)])
def test_fused_block_matches_plain(cuda, n, s, c, block_diag):
    from ips_tpu_torch.ops import conv_block as cb
    x, q = _block_inputs(cuda, n, s, c, block_diag=block_diag)
    before = cb.fused_block.launches
    got = cb.fused_block(x, q)
    assert cb.fused_block.launches == before + 1
    want = cb.plain_fused_block(x, q)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL, msg=f"max abs err {err}")


def test_fused_block_deterministic(cuda):
    from ips_tpu_torch.ops import conv_block as cb
    x, q = _block_inputs(cuda, 64, 13, 128, seed=3)
    assert torch.equal(cb.fused_block(x, q), cb.fused_block(x, q))


# The persistent grid is min(n, SMs): n below, at and past 132 (an H100's
# SM count), and the layer1 chunk; s=16 at c=64 and c=128 take one
# activation buffer, s <= 13 two; c=128 streams its weights, c <= 64 keeps
# them resident; (1600, 7, 7, 128) is layer2_block1's chunk.
@pytest.mark.parametrize("n,s,c", [
    (1, 13, 64), (131, 13, 64), (132, 13, 64), (133, 13, 64),
    (1600, 13, 64), (140, 16, 64), (140, 16, 128), (1600, 7, 128),
    (300, 13, 32), (2, 16, 32), (133, 14, 128)])
def test_fused_block_persistent(cuda, n, s, c):
    from ips_tpu_torch.ops import conv_block as cb
    x, q = _block_inputs(cuda, n, s, c, seed=n + s + c)
    got = cb.fused_block(x, q)
    want = cb.plain_fused_block(x, q)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL, msg=f"max abs err {err}")


@pytest.mark.parametrize("n,s,c", [(1600, 13, 64), (800, 13, 128),
                                   (1600, 7, 128)])
def test_fused_block_deterministic_persistent(cuda, n, s, c):
    from ips_tpu_torch.ops import conv_block as cb
    x, q = _block_inputs(cuda, n, s, c, seed=5)
    assert torch.equal(cb.fused_block(x, q), cb.fused_block(x, q))


def test_fused_block_rejects(cuda):
    from ips_tpu_torch.ops import conv_block as cb
    x, q = _block_inputs(cuda, 4, 5, 64)
    with pytest.raises(ValueError, match="bf16"):
        cb.fused_block(x.float(), q)
    with pytest.raises(ValueError, match="contiguous"):
        cb.fused_block(x.transpose(1, 2), q)
    with pytest.raises(ValueError, match="out of range"):
        cb.fused_block(*_block_inputs(cuda, 2, 5, 256))
    with pytest.raises(ValueError, match="out of range"):
        cb.fused_block(*_block_inputs(cuda, 2, 17, 64))
    with pytest.raises(ValueError, match="out of range"):
        cb.fused_block(*_block_inputs(cuda, 2, 5, 48))
    with pytest.raises(ValueError, match="one device"):
        cb.fused_block(x, {**q, "s1": q["s1"].cpu()})


# ------------------------------------------------------ training on the card
@pytest.fixture()
def no_tf32(cuda):
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = prev


def test_fused_step_kernel_matches_plain(no_tf32):
    """A small fp32 step scored by the kernel against the same step scored
    by the plain version on the card and on the CPU, for each input seed
    of ips_tpu_torch.scripts.train_parity, at its bounds."""
    from ips_tpu_torch.scripts import train_parity as tp
    results = [tp.parity(no_tf32, seed) for seed in tp.SEEDS]
    # ceil((40 - 8) / 8) chunks a selection
    assert [r["launches"] for r in results] == [4] * len(tp.SEEDS)
    tp.check(results)


def test_traffic_step_kernel_matches_plain(no_tf32):
    """One fp32 step of the traffic config's model (ResNet-18 with all 4
    blocks, RGB, a padded tail chunk) scored by the kernel against the
    same step scored by the plain version on the card and on the CPU, at
    the same weights, with train_parity's gate-flip rule."""
    from ips_tpu_torch.scripts import train_parity as tp
    results = [tp.parity(no_tf32, seed, tp.SMALL_TRAFFIC, blank=0.0)
               for seed in tp.SEEDS]
    # ceil((48 - 4) / 8) chunks a selection
    assert [r["launches"] for r in results] == [6] * len(tp.SEEDS)
    tp.check(results, tp.FLIP_TOL_4_BLOCKS)


def test_traffic_input_norm_on_card_matches_host(no_tf32):
    """``input_norm: imagenet`` (uint8 patches, normalized on the card)
    encodes as host-normalized fp32 patches do, to within the uint8
    rounding of the pixels, at the tolerance of the JAX package's own
    test (tests/test_traffic.py, atol 5e-2, rtol 1e-2)."""
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.data.traffic import TrafficSigns
    from ips_tpu_torch.data.traffic_synth import synth_sts_sets
    from ips_tpu_torch.scripts.train_parity import SMALL_TRAFFIC
    from ips_tpu_torch.train.steps import IPSTrainer
    sets = synth_sts_sets(n_per_set=4, height=120, width=160, seed=0)
    base = dict(SMALL_TRAFFIC, img_size=[120, 160])
    emb = {}
    for norm in ("imagenet", "none"):
        conf = config_from_dict(dict(base, input_norm=norm))
        # train items: augmented pixels, which uint8 rounds
        ds = TrafficSigns(conf, train=True, images=sets)
        x = torch.from_numpy(np.stack([ds[i]["input"] for i in range(2)]))
        assert x.dtype == (torch.uint8 if norm == "imagenet"
                           else torch.float32)
        tr = IPSTrainer(conf)
        assert tr.device.type == "cuda"
        with torch.no_grad():
            emb[norm] = tr.model.encode(x.to(no_tf32)).cpu()
    assert emb["none"].shape == (2, 48, 512)
    torch.testing.assert_close(emb["imagenet"], emb["none"], atol=5e-2,
                               rtol=1e-2)


def test_fused_multi_step_launches_kernel_per_chunk(cuda):
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.train.steps import IPSTrainer
    from ips_tpu_torch.scripts.train_parity import SMALL_TRAIN
    conf = config_from_dict(dict(SMALL_TRAIN, N=36, M=4, I=4, shuffle=True,
                                 attn_dropout=0.1, dropout=0.1,
                                 compute_dtype="bfloat16",
                                 input_dtype="bfloat16"))
    tr = IPSTrainer(conf)
    assert tr.device.type == "cuda"
    K = 3
    rng = np.random.default_rng(6)
    args = (torch.from_numpy(rng.random((K, 4, 36, 16, 16, 1), np.float32)
                             ).to(cuda), None,
            {"majority": torch.from_numpy(rng.integers(0, 10, (K, 4))
                                          ).to(cuda),
             "multi": torch.from_numpy((rng.random((K, 4, 10)) < 0.5
                                        ).astype(np.float32)).to(cuda)},
            torch.ones((K, 4), device=cuda))
    before = sk.logits.launches
    losses, _, preds = tr.fused_multi_step(
        *args, [tr.new_generator(k) for k in range(K)], [1e-3] * K)
    assert sk.logits.launches - before == 8 * K   # ceil((36 - 4) / 4) a step
    assert losses.shape == (K,) and bool(torch.isfinite(losses).all())
    assert preds["multi"].shape == (K, conf.B, 10)
    assert tr.step == K


# --------------------------------------------------- sparse input on the card
def _sparse_batch(B, H, W, nnz, n_pad, seed):
    """Sparse pixels as MegapixelMNIST pads them: sorted distinct indices,
    then index-0 value-0 padding."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((B, nnz + n_pad), np.int32)
    val = np.zeros((B, nnz + n_pad), np.float32)
    for b in range(B):
        idx[b, :nnz] = np.sort(rng.choice(H * W, nnz, replace=False))
        val[b, :nnz] = rng.random(nnz)
    return torch.from_numpy(idx), torch.from_numpy(val)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_densify_on_card_equals_cpu(cuda, dtype):
    from ips_tpu_torch.ops.densify import densify_patches
    # the shipped megapixel-MNIST shape: 1500x1500 in 50x50 patches
    idx, val = _sparse_batch(16, 1500, 1500, 7000, 1192, seed=4)
    want = densify_patches(idx, val, (1500, 1500), (50, 50), 1, dtype)
    got = densify_patches(idx.to(cuda), val.to(cuda), (1500, 1500),
                          (50, 50), 1, dtype)
    assert got.device.type == "cuda" and got.dtype == dtype
    assert torch.equal(got.cpu(), want)


def test_fused_sparse_step_selects_as_plain_scorer(no_tf32):
    """A small fp32 sparse step on the card: the kernel-scored selection
    inside it keeps the indices the plain scorer keeps on the densified
    batch, with one kernel launch a chunk."""
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.train.steps import IPSTrainer
    from ips_tpu_torch.scripts.train_parity import SMALL_TRAIN
    conf = config_from_dict(dict(SMALL_TRAIN, N=36, M=4, I=4,
                                 sparse_input=True))
    tr = IPSTrainer(conf)
    cuda = no_tf32
    idx, val = _sparse_batch(4, 96, 96, 900, 124, seed=7)
    idx, val = idx.to(cuda), val.to(cuda)
    rng = np.random.default_rng(8)
    labels = {"majority": torch.from_numpy(rng.integers(0, 10, 4)).to(cuda),
              "multi": torch.from_numpy((rng.random((4, 10)) < 0.5
                                         ).astype(np.float32)).to(cuda)}
    kept = []
    select = tr._select_impl

    def record(*a, **kw):
        out = select(*a, **kw)
        kept.append(out[2])
        return out
    tr._select_impl = record
    dense = tr.densify(idx, val, (96, 96))
    model = tr.model
    with torch.no_grad():
        from ips_tpu_torch.ops.selection import ips_select
        plain = ips_select(
            model.encode,
            lambda e, m: sk.fast_scores(e, model.score_weights(), m),
            dense, M=conf.M, I=conf.I, pos_table=tr.pos_table).mem_idx
    before = sk.logits.launches
    loss, _, _ = tr.fused_sparse_step(idx, val, (96, 96), None, labels,
                                      torch.ones(4, device=cuda), None, 1e-3)
    assert sk.logits.launches - before == 8      # ceil((36 - 4) / 4)
    assert torch.equal(kept[0], plain)
    assert bool(torch.isfinite(loss))


def test_feature_assembled_step_selects_as_plain_scorer(no_tf32):
    """A small fp32 camelyon-style assembled step on the card: four
    bucket-padded slides, each selected with the kernel (one launch per
    chunk) into the indices the plain scorer keeps, then a finite step."""
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.ops.selection import ips_select
    from ips_tpu_torch.train.steps import IPSTrainer
    cuda = no_tf32
    conf = config_from_dict(dict(
        B=4, B_seq=1, n_class=1, is_image=False, n_chan_in=32, n_token=1,
        shuffle=False, M=8, I=8, use_pos=False, H=2, D=16, D_k=8, D_v=8,
        D_inner=32, attn_dropout=0.0, dropout=0.0, ln_fold=True,
        compute_dtype="float32",
        tasks={"task0": {"id": 0, "name": "metastases", "act_fn": "sigmoid",
                         "metric": "auc"}}))
    tr = IPSTrainer(conf)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((4, 1, 24, 32), np.float32))
    mask = torch.arange(24)[None, None] < torch.tensor(
        [24, 19, 17, 9])[:, None, None]
    x, mask = (x * mask[..., None]).to(cuda), mask.to(cuda)
    model = tr.model
    with torch.no_grad():
        plain = [ips_select(
            model.encode,
            lambda e, m: sk.fast_scores(e, model.score_weights(), m),
            x[j], M=conf.M, I=conf.I, mask=mask[j]).mem_idx
            for j in range(4)]
    kept = []
    select = tr._select_impl

    def record(*a, **kw):
        out = select(*a, **kw)
        kept.append(out[2])
        return out
    tr._select_impl = record
    labels = {"metastases": torch.tensor([0, 1, 0, 1], device=cuda)}
    before = sk.logits.launches
    loss, _, _ = tr.fused_assembled_step(
        x, mask, labels, torch.ones(4, device=cuda), None, None, 1e-3)
    assert sk.logits.launches - before == 4 * 2  # ceil((24 - 8) / 8) a slot
    for got, want in zip(kept, plain):
        assert torch.equal(got, want)
    assert bool(torch.isfinite(loss))


# ------------------------------------------- streaming and pre-encoded selection
def _e2e_trainer(device, **over):
    """A small camelyon_e2e-like model: uint8 RGB tiles, ResNet-50 cut
    after layer2, M = 8, I = 6, shuffle on."""
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.train.steps import IPSTrainer
    conf = config_from_dict(dict(dict(
        B=1, B_seq=1, n_class=1, is_image=True, enc_type="resnet50",
        n_chan_in=3, n_res_blocks=2, n_token=1, N=0, M=8, I=6,
        patch_size=[32, 32], patch_stride=[32, 32], use_pos=False, H=2,
        D=512, D_k=8, D_v=8, D_inner=32, compute_dtype="float32",
        eager=False, stream_chunk_group=4, shuffle=True,
        tasks={"t": {"id": 0, "name": "t", "act_fn": "sigmoid",
                     "metric": "auc"}}), **over))
    return IPSTrainer(conf, device=device, init_opt=False)


def _tiles(N=61, n_valid=55, B=1, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (B, N, 32, 32, 3), np.uint8)
    mask = np.zeros((B, N), bool)
    mask[:, :n_valid] = True
    return x, mask


def test_streaming_groups_equal_per_chunk_on_card(no_tf32):
    """Pinned, double-buffered stages of G = 4 chunks give the G = 1
    per-chunk selection bitwise (8 chunks after the first M: one group,
    a remainder of 4 one by one, the last ragged), and the eager
    ips_select on the card from a generator of the same seed; padded
    tiles are never kept."""
    from ips_tpu_torch.train.streaming import StreamingSelector
    tr = _e2e_trainer(no_tf32)
    x, mask = _tiles()
    one = StreamingSelector(tr)
    one.group = 1
    before = sk.logits.launches
    g4 = tr.select_streaming(x, mask, tr.new_generator(5), return_emb=True)
    assert sk.logits.launches - before == 9          # ceil((61 - 8) / 6)
    with torch.no_grad():
        g1 = one.select(x, mask, tr.new_generator(5), return_emb=True)
    for a, b in zip(g4[2:], g1[2:]):
        assert torch.equal(a, b)
    kept = tr.select_streaming(x, mask, tr.new_generator(5))
    eager = tr.select(torch.from_numpy(x).to(no_tf32),
                      torch.from_numpy(mask).to(no_tf32),
                      tr.new_generator(5))
    assert torch.equal(kept[2], eager[2]) and torch.equal(kept[0], eager[0])
    assert kept[0].dtype == torch.uint8 and kept[0].device.type == "cuda"
    assert int(kept[2].max()) < 55


def test_preencode_matches_per_chunk_on_card(no_tf32):
    """preencode_select=true (chunked: a conv encoder) keeps the
    per-chunk selection's indices on the card."""
    x, mask = _tiles(N=40, n_valid=37)
    xd = torch.from_numpy(x).to(no_tf32)
    md = torch.from_numpy(mask).to(no_tf32)
    tr = _e2e_trainer(no_tf32, eager=True)
    pre = _e2e_trainer(no_tf32, eager=True, preencode_select=True)
    pre.model.load_state_dict(tr.model.state_dict())
    a = tr.select(xd, md, tr.new_generator(2))
    b = pre.select(xd, md, pre.new_generator(2))
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


# ------------------------------------------- preprocessing: ResNet-50 / 4
@pytest.fixture()
def r50_npz(tmp_path):
    from ips_tpu_torch.models import pretrained as pt
    path = str(tmp_path / "r50.npz")
    pt.save_npz(path, pt.torch_resnet_to_flat(
        pt.seeded_state_dict("resnet50", 4), "resnet50"))
    return path


def _r50_card_cpu(device, npz, card_dtype, cpu_dtype):
    """Features of 6 random tiles: the card's encoder in ``card_dtype``,
    the CPU's in ``cpu_dtype``, both at the npz's weights."""
    from ips_tpu_torch.models.encoders import ConvPatchEncoder
    from ips_tpu_torch.models.pretrained import load_encoder_npz

    def encoder(dtype):
        return load_encoder_npz(npz, ConvPatchEncoder(
            "resnet50", 3, 4, dtype=dtype), expect_cover=True).eval()
    x = torch.from_numpy(np.random.default_rng(3).random(
        (6, 224, 224, 3), np.float32))
    with torch.inference_mode():
        want = encoder(cpu_dtype)(x).numpy()
        got = encoder(card_dtype).to(device)(x.to(device)).cpu().numpy()
    assert got.shape == (6, 2048) and np.isfinite(got).all()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# fp32 with TF32 off: the same products summed in another order; bf16: a
# rounding flip carried by the later convs (relative Frobenius distance),
# tight enough that an fp32 forward on the card fails it (the next test).
# On the H100 the bf16 case reads 9.88e-4 and the fp32 control 3.07e-3
R50_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_resnet50_full_depth_card_matches_cpu(no_tf32, r50_npz, dtype):
    rel = _r50_card_cpu(no_tf32, r50_npz, dtype, dtype)
    print(f"card against CPU, {dtype}: relative distance {rel:.3e}")
    assert rel < R50_REL[dtype]


def test_resnet50_bf16_tolerance_refuses_fp32(no_tf32, r50_npz):
    """The control of the bf16 case: an encoder that ran in fp32 on the
    card, held against the CPU's bf16 forward, fails its tolerance."""
    rel = _r50_card_cpu(no_tf32, r50_npz, torch.float32, torch.bfloat16)
    print(f"card fp32 against CPU bf16: relative distance {rel:.3e}")
    assert rel >= R50_REL[torch.bfloat16]


def test_pipelined_extraction_equals_synchronous_on_card(no_tf32,
                                                         r50_npz):
    """Two pinned buffers in flight, the tail batch padded: the pipelined
    features equal batch-by-batch synchronous ones bitwise, and the
    encoder's own forward of the padded batch."""
    from ips_tpu_torch.data.camelyon.extract_feat import PipelinedEncoder
    enc = PipelinedEncoder(pretrained_path=r50_npz, batch_size=8)
    assert enc.device.type == "cuda"
    tiles = np.random.default_rng(5).integers(0, 256, (29, 224, 224, 3),
                                              np.uint8)
    batches = [tiles[s:s + 8] for s in range(0, 29, 8)]
    piped, pending = [], None
    for b in batches:
        h = enc.dispatch(b)
        if pending is not None:
            piped.append(enc.fetch(pending))
        pending = h
    piped.append(enc.fetch(pending))
    sync = [enc.fetch(enc.dispatch(b)) for b in batches]
    for p, s in zip(piped, sync):
        assert p.dtype == np.float32 and np.array_equal(p, s)
    tail = torch.zeros((8, 224, 224, 3), dtype=torch.uint8)
    tail[:5] = torch.from_numpy(batches[-1])
    with torch.inference_mode():
        want = enc.model(tail.to(no_tf32).float() / 255.0)[:5].cpu().numpy()
    assert np.array_equal(piped[-1], want)


# -------------------------------------- int8 selection and export (card)
INT8_TINY = dict(
    B=2, B_seq=2, n_class=10, n_chan_in=1, n_token=2, N=23, M=4, I=5,
    patch_size=[16, 16], patch_stride=[16, 16], use_pos=True, H=4, D=128,
    D_k=16, D_v=16, D_inner=256, compute_dtype="float32", shuffle=False,
    tasks={"t": {"id": 0, "name": "t", "act_fn": "softmax",
                 "metric": "accuracy"}})


def _smoke_module():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k,c_in,c_out,stride,pad,n", [
    (7, 1, 64, 2, 3, 40), (7, 3, 64, 2, 3, 8), (3, 64, 128, 2, 1, 16),
    (1, 256, 512, 2, 0, 4), (3, 64, 64, 1, 1, 1)])
def test_int8_conv_card_equals_cpu(cuda, k, c_in, c_out, stride, pad, n):
    """torch._int_mm's int32 sums (cuBLASLt on the card) equal the CPU's,
    through the padded im2col of models/quant.py; the last case has fewer
    than 17 rows."""
    from ips_tpu_torch.models.quant import int8_conv
    rng = np.random.default_rng(k + c_in + n)
    xq = torch.from_numpy(rng.integers(-127, 128, (n, 9, 9, c_in))
                          .astype(np.int8))
    kq = torch.from_numpy(rng.integers(-127, 128, (c_out, c_in, k, k))
                          .astype(np.int8))
    got = int8_conv(xq.to(cuda), kq.to(cuda), stride, pad)
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), int8_conv(xq, kq, stride, pad))


def test_int8_select_card_matches_cpu(no_tf32):
    """The int8 selection on the card keeps the CPU's indices, or parts
    from them only at a near-tie (the gap at the M-th place within twice
    the two scorings' largest difference, chip_smoke.py's rule)."""
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.train.steps import IPSTrainer
    conf = config_from_dict(dict(INT8_TINY, select_dtype="int8"))
    card = IPSTrainer(conf)
    cpu = IPSTrainer(conf, device="cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    rng = np.random.default_rng(4)
    x = rng.random((2, 23, 16, 16, 1), np.float32)
    x[:, rng.random(23) < 0.4] = 0.0
    x = torch.from_numpy(x)
    mask = torch.ones((2, 23), dtype=torch.bool)
    xc, mc = x.to(no_tf32), mask.to(no_tf32)
    before = sk.logits.launches
    got = card.select(xc, mc)[2].cpu()
    assert sk.logits.launches - before == 4
    want = cpu.select(x, mask)[2]
    if torch.equal(got, want):
        return
    smoke = _smoke_module()
    enc_card, _ = card._enc_score_fns()
    enc_cpu, _ = cpu._enc_score_fns()
    rows = torch.arange(2)[:, None]

    def cpu_scores(i, e, v):
        i = i.cpu()
        emb = enc_cpu(x[rows, i]) + cpu.pos_table[i]
        return cpu.model.scores(emb, v.cpu()).to(no_tf32)
    report = smoke.tie_report(
        torch, card.model, conf, card.pos_table, xc, mc, None,
        lambda i: enc_card(xc[rows.to(no_tf32), i]), cpu_scores)
    smoke._check_near_tie(report, "int8 selection on the card")


def test_exported_program_on_card_matches_live(cuda, tmp_path):
    """The Predictor exported on the card, saved and loaded, against the
    live one: selected indices equal, probabilities within 1e-5, and the
    kernel launched once a chunk inside the program."""
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.export import ExportedPredictor, export_predictor
    from ips_tpu_torch.infer import Predictor
    live = Predictor(config_from_dict(dict(INT8_TINY)))
    path = str(tmp_path / "m.pt2")
    torch.export.save(export_predictor(live, batch_size=2), path)
    model = ExportedPredictor.load(path)
    assert model.device.type == "cuda"
    x = np.random.default_rng(5).random((2, 23, 16, 16, 1), np.float32)
    before = sk.logits.launches
    out = model.predict(x)
    assert sk.logits.launches - before == 4       # ceil((23 - 4) / 5)
    ref = live.predict(x)
    np.testing.assert_array_equal(out["selected_idx"], ref["selected_idx"])
    np.testing.assert_allclose(out["t"], ref["t"], rtol=0, atol=1e-5)


# ------------------------------------------- collectives of the parallel port
@pytest.mark.parametrize("backend,world", [("gloo", 2), ("gloo", 4),
                                           ("nccl", 1)])
def test_collectives_on_card_are_exact(cuda, tmp_path, backend, world):
    """all_gather_rows, the BatchNorm's differentiable group sum (and its
    backward) and the gradient all-reduce on CUDA tensors, over 2 and 4
    gloo ranks sharing cuda:0 (the 2x2 mesh's world) and a 1-rank NCCL
    group, bitwise equal to the same sums in one process."""
    import os

    from ips_tpu_torch.parallel.launch import run_world
    from torch_parallel_worker import collective_parts
    run_world("torch_parallel_worker:collectives", world,
              [str(tmp_path), backend], timeout=120,
              python_path=[os.path.dirname(os.path.abspath(__file__))])
    parts, ws = collective_parts(world, cuda)
    total, dtotal = sum(parts[1:], parts[0]), sum(ws[1:], ws[0])
    for r in range(world):
        got = torch.load(tmp_path / f"{backend}{r}.pt")
        assert got["device"] == "cuda:0"
        assert torch.equal(got["gathered"], torch.cat(parts, 1).cpu())
        assert torch.equal(got["summed"], total.cpu())
        assert torch.equal(got["dsum"], dtotal.cpu())
        assert torch.equal(got["grads"][0], (total * 0.5).cpu())
        assert torch.equal(got["grads"][1], (2 * total * 0.5).cpu())


def test_streaming_at_1x2_on_card_stages_half_chunks(no_tf32, tmp_path):
    """Two gloo ranks sharing cuda:0 stream one slide at 1x2: every stage
    of each rank holds I / 2 tiles of each chunk (the kept gather stays
    whole), and the kept indices are bitwise one process's."""
    import os

    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.parallel.launch import run_world
    from ips_tpu_torch.train.steps import IPSTrainer
    from torch_parallel_worker import CARD_STREAM, card_slide
    run_world("torch_parallel_worker:stream_card", 2, [str(tmp_path)],
              timeout=120,
              python_path=[os.path.dirname(os.path.abspath(__file__))])
    tr = IPSTrainer(config_from_dict(CARD_STREAM))
    x, m = card_slide()
    want = tr.select_streaming(x, m, tr.new_generator(5))[2].cpu()
    half = CARD_STREAM["I"] // 2
    for r in range(2):
        got = torch.load(tmp_path / f"card{r}.pt")
        assert got["device"] == "cuda:0"
        assert torch.equal(got["idx"], want)
        *chunks, kept = got["staged"]
        assert all(s[-1] == half for s in chunks) and kept[-1] == 8


# ------------------------------------- the gradient re-encode out of memory
@pytest.mark.parametrize("chunk", [0, 512], ids=["c0", "c_eq_M"])
def test_grad_encode_out_of_memory_on_card(no_tf32, chunk):
    """A real allocation too large for the card: train_parity's small
    model (D = 128, ResNet-18/2, fp32) on 224x224 RGB tiles re-encodes B·M
    = 8·512 = 4096 of them with gradients at once (grad_encode_chunk 0,
    or M). The trainer raises GradEncodeMemoryError from PyTorch's error,
    naming the setting, B·M and the allocator's figures, before any
    update; once the error is dropped its memory is free again."""
    import gc

    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.scripts.train_parity import SMALL_TRAIN
    from ips_tpu_torch.train.steps import GradEncodeMemoryError, IPSTrainer
    B, M = 8, 512
    conf = config_from_dict(dict(
        SMALL_TRAIN, B=B, B_seq=B, n_chan_in=3, N=M, M=M, I=M,
        patch_size=[224, 224], patch_stride=[224, 224],
        grad_encode_chunk=chunk))
    tr = IPSTrainer(conf)
    g = torch.Generator(device=no_tf32).manual_seed(0)
    x = torch.randint(0, 256, (B, M, 224, 224, 3), dtype=torch.uint8,
                      device=no_tf32, generator=g)
    labels = {"majority": torch.arange(B, device=no_tf32) % 10,
              "multi": torch.ones((B, 10), device=no_tf32)}
    pos = tr.pos_table[:M].expand(B, M, -1)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with pytest.raises(GradEncodeMemoryError) as err:
        tr.train_step(x, pos, None, labels, torch.ones(B, device=no_tf32),
                      tr.new_generator(0), 1e-3)
    text = str(err.value)
    assert f"grad_encode_chunk={chunk}" in text
    assert f"B·M = {B}·{M} = {B * M}" in text
    assert "GiB allocated" in text and "asked for" in text
    assert isinstance(err.value.__cause__, torch.cuda.OutOfMemoryError)
    assert tr.step == 0 and not tr.opt.state
    assert all(p.grad is None for p in tr.model.parameters())
    # the BatchNorm running statistics may hold the batches encoded
    # before the failure; the parameters are the ones before the step
    params = dict(tr.model.named_parameters())
    assert all(torch.equal(params[k], before[k]) for k in params)
    # what the failed step held (~76 GiB) is free once the error is gone;
    # the library workspaces it made may stay (65 MiB at c = M on the
    # H100)
    del err
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() < base + 2**30

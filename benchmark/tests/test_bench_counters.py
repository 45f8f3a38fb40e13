"""The FLOP and byte counters against hand counts worked from the layer
shapes, and the metric readers on a made-up trace."""

import pytest

from benchmark import core, flops, peaks
from benchmark.trace import Trace

MNIST = core.find_cell("mnist.train").config
E2E = core.find_cell("camelyon_e2e.train").config


def test_resnet18_two_stages_on_a_50px_patch():
    # stem 25x25x49x1x64; layer1 4 convs 13x13x9x64x64; layer2 at 7x7:
    # 9x64x128 + 9x128x128 + 64x128 (downsample) + 2 x 9x128x128
    hand = (625 * 49 * 64 + 4 * 169 * 9 * 64 * 64
            + 49 * (9 * 64 * 128 + 9 * 128 * 128 + 64 * 128
                    + 2 * 9 * 128 * 128))
    assert flops.encoder_macs("resnet18", 2, (50, 50), 1) == hand
    assert abs(hand / 1e6 - 52.6) < 0.05


def test_resnet50_two_stages_on_a_224px_tile():
    stem = 112 * 112 * 49 * 3 * 64
    l1 = 3136 * (64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256) \
        + 2 * 3136 * (256 * 64 + 9 * 64 * 64 + 64 * 256)
    # the stride sits on the 3x3 of layer2's first block
    l2 = 3136 * 256 * 128 + 784 * (9 * 128 * 128 + 128 * 512 + 256 * 512) \
        + 3 * 784 * (512 * 128 + 9 * 128 * 128 + 128 * 512)
    assert flops.encoder_macs("resnet50", 2, (224, 224), 3) == stem + l1 + l2
    assert abs((stem + l1 + l2) / 1e9 - 1.81) < 0.01


def test_scorer_bytes_and_flops():
    # MNIST fp32: x (16, 200, 128), W (128, 32), logits (16, 200, 32)
    assert flops.score_bytes(16, 200, 128, 32, 4) == \
        4 * (16 * 200 * 128 + 128 * 32) + 4 * 16 * 200 * 32
    assert flops.score_flops(16, 200, 128, 32) == 2 * 16 * 200 * 128 * 32
    bound = flops.score_bytes(16, 200, 128, 32, 4) / peaks.HBM_BYTES_PER_S
    assert bound == pytest.approx(0.616e-6, rel=2e-3)


def test_a_training_step_and_a_request():
    enc = 2 * 52_570_176
    sel = 16 * 900 * enc + 8 * flops.score_flops(16, 200, 128, 32)
    agg = flops.aggregator_flops(MNIST, 16, 100)
    assert flops.train_step_flops(MNIST, [900] * 16, 900) == \
        sel + 3 * (16 * 100 * enc + agg)
    assert flops.request_flops(MNIST, [900] * 16, 900) == sel + agg
    assert flops.merges(2304, 256, 256) == 8


def _trace():
    # window 0..100 ns; kernels at 10-30 and 20-40 overlap, 60-70 apart
    return Trace((0, 100), [("elementwise_kernel", 10, 20),
                            ("cudnn_fprop", 20, 20),
                            ("Memcpy HtoD (Pinned -> Device)", 60, 10)],
                 [("loader_wait", 40, 60), ("train_one_epoch", 0, 100)],
                 [((16, 200, 128), (128, 32), "float")], 2, score_s=4e-6)


def test_trace_union_gaps_and_readers():
    tr = _trace()
    assert tr.busy_intervals() == [(10, 40), (60, 70)]
    assert tr.busy_s == pytest.approx(40e-9)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["train_one_epoch", 30e-9]
    assert ["loader_wait", 20e-9] in gaps
    rec = core.Record("mnist.train", MNIST, {}, trace=tr, steps=2)
    read = {n: core.metric_reader(n)(rec) for n in (
        "device_idle_share.train", "h2d_ms.train", "conv_ms.train",
        "elementwise_ms.train", "loader_wait_ms.train",
        "score_logits_roofline.train", "device_idle_share.serve")}
    assert read["device_idle_share.train"] == pytest.approx(60.0)
    assert read["h2d_ms.train"] == pytest.approx(10e-9 * 1e3 / 2)
    assert read["conv_ms.train"] == pytest.approx(20e-9 * 1e3 / 2)
    assert read["elementwise_ms.train"] == pytest.approx(20e-9 * 1e3 / 2)
    assert read["loader_wait_ms.train"] == pytest.approx(20e-9 * 1e3 / 2)
    # the fp32 (16, 200, 128) x (128, 32) launch is bound by its bytes
    bound = flops.score_bytes(16, 200, 128, 32, 4) / peaks.HBM_BYTES_PER_S
    assert read["score_logits_roofline.train"] == pytest.approx(
        100 * bound / 4e-6)
    # a '.train' and a '.serve' metric share one reader file
    assert read["device_idle_share.serve"] == read["device_idle_share.train"]


def test_readers_find_nothing_without_a_trace():
    rec = core.Record("mnist.train", MNIST, {})
    for n in ("mfu.train", "score_logits_roofline.train",
              "device_idle_share.serve", "h2d_ms.serve", "serve_p95_ms",
              "train_patches_per_s", "peak_mem_mib"):
        assert core.metric_reader(n)(rec) is None

"""The loader's draw rule on traffic: each train item's augmentation draw
is its place in the epoch's global item order, so loader threads and
data ranks load the batches of one process without threads.

The reference is the JAX package's ``DataLoader`` without threads over
its ``TrafficSigns`` (its shared draw counter depends on thread timing
with threads, so it is read without). Every comparison is bitwise, on
the synthetic corpus of tests/test_torch_traffic.py (120x160).
"""

import importlib.util
import os

import numpy as np
import pytest

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.data import loader as j_loader
from ips_tpu.data import traffic as jt
from ips_tpu.data import traffic_synth as js
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.data import loader as t_loader
from ips_tpu_torch.data import traffic as tt

from test_torch_data import Indexed
from test_torch_traffic import SYNTH, conf_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
SEED = 2
EPOCHS = 3


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sts_draws"))
    js.generate_synth_sts(d, **SYNTH)
    return d


def _conf(synth_dir):
    return conf_dict(synth_dir, shuffle=True, seed=SEED)


def port_loader(synth_dir, **kw):
    return t_loader.DataLoader(
        tt.TrafficSigns(t_config(_conf(synth_dir)), True), batch_size=B,
        shuffle=True, seed=SEED, **kw)


def jax_loader(synth_dir, **kw):
    return j_loader.DataLoader(
        jt.TrafficSigns(j_config(_conf(synth_dir)), True), batch_size=B,
        shuffle=True, seed=SEED, **kw)


def epochs(loader, n=EPOCHS):
    return [list(loader) for _ in range(n)]


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def assert_epochs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)


@pytest.fixture(scope="module")
def jax_epochs(synth_dir):
    """The JAX package's loader without threads, one process, 3 epochs;
    and the same with drop_last."""
    return (epochs(jax_loader(synth_dir)),
            epochs(jax_loader(synth_dir, drop_last=True), 2))


def test_unthreaded_batches_as_jax(synth_dir, jax_epochs):
    """One process without threads: every item takes the draw it took
    before the draw rule, as in the JAX package; over whole epochs, and
    after an epoch left unread after its first batch."""
    full, dropped = jax_epochs
    assert len(full[0]) == 3 and full[0][0]["input"].shape[0] == B
    assert_epochs_equal(epochs(port_loader(synth_dir)), full)
    assert_epochs_equal(epochs(port_loader(synth_dir, drop_last=True), 2),
                        dropped)
    partial = {}
    for make, ds_next in ((port_loader, lambda ds: ds.take_draws(0)),
                          (jax_loader, lambda ds: next(ds._draw))):
        ld = make(synth_dir)
        next(iter(ld))
        rest = list(ld)
        partial[make] = (rest, ds_next(ld.dataset))
    assert_batches_equal(partial[port_loader][0], partial[jax_loader][0])
    n = B + len(port_loader(synth_dir).dataset)
    assert partial[port_loader][1] == partial[jax_loader][1] == n


@pytest.mark.parametrize("workers", [4, 8])
def test_threaded_batches_equal_unthreaded(synth_dir, jax_epochs, workers):
    """Any thread count loads the batches of no threads, bitwise, in
    every epoch and every run."""
    for _ in range(3):
        assert_epochs_equal(
            epochs(port_loader(synth_dir, num_workers=workers)),
            jax_epochs[0])


@pytest.mark.parametrize("workers", [0, 4])
def test_rank_rows_equal_one_drop_last_process(synth_dir, jax_epochs,
                                               workers):
    """Data rank p of 2 loads rows [2p, 2p + 2) of one drop_last
    process's batches in epochs 0 and 1 (the second epoch's draws start
    after the first's global items)."""
    one = jax_epochs[1]
    for p in range(2):
        got = epochs(port_loader(synth_dir, num_workers=workers,
                                 process_index=p, process_count=2), 2)
        want = [[{k: v[2 * p:2 * p + 2] for k, v in b.items()} for b in e]
                for e in one]
        assert_epochs_equal(got, want)


def test_direct_items_take_the_next_draw(synth_dir):
    """``dataset[i]`` takes the next draw, one a call, as the JAX
    package's items do; ``item(i, draw)`` and ``augment`` take it given."""
    port = tt.TrafficSigns(t_config(_conf(synth_dir)), True)
    jax_ds = jt.TrafficSigns(j_config(_conf(synth_dir)), True)
    order = [3, 0, 3, 5, 1]
    got = [port[i] for i in order]
    for d, (i, g) in enumerate(zip(order, got)):
        np.testing.assert_array_equal(g["input"], jax_ds[i]["input"])
        np.testing.assert_array_equal(port.item(i, d)["input"], g["input"])
    assert port.take_draws(3) == len(order) and port.take_draws(1) == 8
    img = port._load_image(port._data[2][0])
    np.testing.assert_array_equal(port.augment(img, 2, 4),
                                  port.augment(img, 2, 4))
    assert port.take_draws(0) == 9      # an explicit draw moves nothing


class Reserving(Indexed):
    """Hands out draws in blocks and records what each fetch got."""

    def __init__(self, n):
        super().__init__(n)
        self.next = 0

    def take_draws(self, n):
        first, self.next = self.next, self.next + n
        return first

    def item(self, i, draw):
        return dict(super().__getitem__(i), d=np.int64(draw))


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, seed=3),
    dict(batch_size=4, shuffle=True, seed=3, drop_last=True),
    dict(batch_size=4, shuffle=True, seed=7, bucket_fn=lambda i: i % 3,
         drop_last=True)], ids=["shuffle", "drop_last", "bucket_drop_last"])
def test_draws_are_places_in_the_global_order(kw, workers):
    """Row r of global batch j takes the draw of its place in the epoch's
    global order; ranks keep their rows' draws; epoch 2 goes on where
    epoch 1 ended; the items are the JAX loader's."""
    one = Reserving(23)
    ld = t_loader.DataLoader(one, num_workers=workers, **kw)
    got = [[(b["i"].tolist(), b["d"].tolist()) for b in ld]
           for _ in range(2)]
    flat = [d for e in got for _, ds in e for d in ds]
    assert flat == list(range(len(flat))) and one.next == len(flat)
    ref = j_loader.DataLoader(Indexed(23), **kw)
    want = [[b["i"].tolist() for b in ref] for _ in range(2)]
    assert [[i for i, _ in e] for e in got] == want
    if "drop_last" not in kw:
        return
    for p in range(2):
        rank = t_loader.DataLoader(Reserving(23), num_workers=workers,
                                   process_index=p, process_count=2, **kw)
        rows = slice(2 * p, 2 * p + 2)
        assert [[(b["i"].tolist(), b["d"].tolist()) for b in rank]
                for _ in range(2)] == [
            [(i[rows], d[rows]) for i, d in e] for e in got]


def test_unread_threaded_epoch_reserves_at_most_prefetch_plus_one():
    """A threaded epoch left after its first batch has reserved the draws
    of that batch and of at most ``prefetch + 1`` batches more."""
    ds = Reserving(40)
    ld = t_loader.DataLoader(ds, batch_size=4, num_workers=2, prefetch=2)
    it = iter(ld)
    next(it)
    it.close()
    assert 4 <= ds.next <= 4 * (1 + 2 + 1)


@pytest.mark.parametrize("workers", [0, 3])
def test_dataset_without_take_draws_loads_as_before(workers):
    """A dataset without ``take_draws`` is fetched by ``dataset[i]``, even
    when it has an ``item`` method, and loads the JAX loader's batches,
    on one process and on each of 2 ranks."""
    class WithItem(Indexed):
        def __init__(self, n):
            super().__init__(n)
            self.fetched = []

        def __getitem__(self, i):
            self.fetched.append(i)
            return super().__getitem__(i)

        def item(self, i, draw):
            raise AssertionError("item() without take_draws")

    for p, n in ((0, 1), (0, 2), (1, 2)):
        kw = dict(batch_size=4, shuffle=True, seed=5, process_index=p,
                  process_count=n)
        ds = WithItem(23)
        ld = t_loader.DataLoader(ds, num_workers=workers, **kw)
        got = [[b["i"].tolist() for b in ld] for _ in range(2)]
        ref = j_loader.DataLoader(Indexed(23), **kw)
        assert got == [[b["i"].tolist() for b in ref] for _ in range(2)]
        assert sorted(ds.fetched) == sorted(i for e in got for b in e
                                            for i in b)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_draw_check_passes_and_catches_a_shared_counter(
        smoke, monkeypatch):
    """chip_smoke.py's host check of the draw rule (phase traffic, there
    at 1200x1600) at 120x160: it passes, and it raises when items ignore
    the draw they are handed and take the dataset's next one."""
    from ips_tpu_torch.data.traffic_synth import synth_sts_sets
    sets = synth_sts_sets(**SYNTH)
    conf = t_config(conf_dict("", n_worker=4, seed=SEED))
    assert smoke.check_traffic_draws(np, conf, sets) >= 0
    item = tt.TrafficSigns.item
    monkeypatch.setattr(tt.TrafficSigns, "item", lambda self, i, draw: item(
        self, i, self.take_draws(1)))
    with pytest.raises(AssertionError, match="traffic draws"):
        smoke.check_traffic_draws(np, conf, sets)

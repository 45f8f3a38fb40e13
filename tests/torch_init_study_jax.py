"""The JAX package's arm of the initial-draw study
(``ips_tpu_torch/scripts/init_study.py``), on the CPU, and the writer of
both packages' draws. Not a test module: ``tests/test_torch_init_study.py``
calls it, and it runs from the repository root::

    JAX_PLATFORMS=cpu python tests/torch_init_study_jax.py --write-draws 0-7 \\
        --init-dir DRAWS
    JAX_PLATFORMS=cpu taskset -c 0-1 python tests/torch_init_study_jax.py \\
        --width reduced --store STORE --init-dir DRAWS --init-seeds 0-7 \\
        [--init-name port] [--stop-when-learned] --out jax.jsonl

``--write-draws`` writes ``jax_<s>.npz`` (``write_jax_init`` of
tests/test_torch_mnist_shipped.py at the study's config: the JAX
package's ``init_ips_model`` from ``PRNGKey(s)``) and ``port_<s>.npz``
(the port's ``IPSTrainer`` drawing from ``torch.Generator().manual_seed(
s)``, saved by ``weights.to_flat``), so that either package's draw can
enter either package. Training (``train_jax``) builds the JAX trainer through
``ips_tpu.main.build_trainer`` at the stream seed, replaces its params
and batch_stats with the ``.npz`` unflattened into flax's trees, and runs
``ips_tpu.train.loop.train_one_epoch`` and ``evaluate`` as
``ips_tpu/main.py``'s ``run`` does, through the port script's
``train_draw``: the same JSON lines and summaries, with
``"trainer": "jax"``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
for _p in (REPO, TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from ips_tpu_torch.scripts import init_study  # noqa: E402


def write_draws(out_dir: str, seeds, config: dict) -> list:
    """``jax_<s>.npz`` and ``port_<s>.npz`` for each seed; their paths."""
    import torch

    from ips_tpu_torch import weights
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.train.steps import IPSTrainer
    from test_torch_mnist_shipped import write_jax_init
    os.makedirs(out_dir, exist_ok=True)
    conf = config_from_dict(config)
    paths = []
    for s in seeds:
        path = os.path.join(out_dir, f"jax_{s}.npz")
        write_jax_init(path, s, config)
        paths.append(path)
        tr = IPSTrainer(conf, device="cpu", init_opt=False,
                        generator=torch.Generator().manual_seed(s))
        path = os.path.join(out_dir, f"port_{s}.npz")
        np.savez(path, **weights.to_flat(tr.model))
        paths.append(path)
    return paths


def load_draw(trainer, path: str) -> None:
    """Replace the JAX trainer's params and batch_stats by the flat
    reference-named ``.npz`` at ``path`` (JAX layout, as
    ``weights.flatten_variables`` writes it). Every key, shape and dtype
    must match the trainer's trees; the AdamW state, zeros at the start,
    stays."""
    import jax.numpy as jnp
    from flax.core import freeze, unfreeze
    from flax.core.frozen_dict import FrozenDict
    from flax.traverse_util import flatten_dict, unflatten_dict
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    trees = {}
    for col in ("params", "batch_stats"):
        old_tree = getattr(trainer.state, col)
        old = flatten_dict(unfreeze(old_tree), sep="/")
        new = {k[len(col) + 1:]: v for k, v in flat.items()
               if k.startswith(col + "/")}
        if new.keys() != old.keys():
            raise KeyError(f"{path}: {col} keys differ: "
                           f"{sorted(new.keys() ^ old.keys())}")
        for k, v in old.items():
            if new[k].shape != v.shape or new[k].dtype != v.dtype:
                raise ValueError(f"{path}: {col}/{k} is {new[k].dtype}"
                                 f"{new[k].shape}, not {v.dtype}{v.shape}")
        tree = unflatten_dict({k: jnp.asarray(v) for k, v in new.items()},
                              sep="/")
        trees[col] = freeze(tree) if isinstance(old_tree, FrozenDict) \
            else tree
    trainer.state = trainer.state.replace(**trees)


def train_jax(conf, train, test, draws, stop_after: int, *,
              stop_when_learned: bool = False, out: str = "",
              width: str = "reduced") -> list:
    """The JAX package trained from each (meta, path) of ``draws`` in
    turn (a trainer built at ``conf.seed``, its trees replaced by the
    ``.npz``); the summaries."""
    import ips_tpu.main as j_main
    from ips_tpu.train.loop import evaluate, train_one_epoch
    from ips_tpu.train.metrics import MetricsLogger
    summaries = []
    for meta, path in draws:
        trainer = j_main.build_trainer(conf)
        load_draw(trainer, path)
        meta = dict(meta, trainer="jax", width=width, stream_seed=conf.seed)
        summaries.append(init_study.train_draw(
            trainer, lambda: j_main.build_loaders(conf, train, test), conf,
            meta, train_one_epoch=train_one_epoch, evaluate=evaluate,
            logger_cls=MetricsLogger, stop_after=stop_after,
            stop_when_learned=stop_when_learned, out=out))
    return summaries


def main(argv=None) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    init_study.add_common_args(p)
    p.add_argument("--write-draws", default="",
                   help="seeds whose jax_ and port_ .npz to write into "
                        "--init-dir first")
    a = p.parse_args(argv)
    import torch
    torch.set_num_threads(a.threads)
    smoke = init_study.chip_smoke()
    if a.write_draws:
        config = init_study.study_config(smoke, a.width, a.store or "unused",
                                         a.stream_seed)
        for path in write_draws(a.init_dir, init_study.parse_seeds(
                a.write_draws), config):
            print(path, flush=True)
    if not a.init_seeds:
        return 0
    if not a.store:
        p.error("--store is required to train")
    import ips_tpu.main as j_main
    from ips_tpu.config import config_from_dict
    init_study.ensure_store(a.store, init_study.store_args(
        smoke, a.width, a.n_train, a.n_test))
    conf = config_from_dict(init_study.study_config(
        smoke, a.width, a.store, a.stream_seed))
    conf = conf.replace(n_worker=min(conf.n_worker, a.threads))
    train, test = j_main.build_datasets(conf, "mnist")
    summaries = train_jax(
        conf, train, test,
        init_study.draw_list("", a.init_dir, a.init_seeds, a.init_name),
        init_study.stop_after(a), stop_when_learned=a.stop_when_learned,
        out=a.out, width=a.width)
    return 0 if all(s["finite"] for s in summaries) else 1


if __name__ == "__main__":
    sys.exit(main())

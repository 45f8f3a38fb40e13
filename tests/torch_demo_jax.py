"""The JAX package's side of the README demo (examples/minimal_ips.py)
for the port's demo (ips_tpu_torch/examples/minimal_ips.py), on the CPU.
Not a test module: ``tests/test_torch_demo.py`` calls it, and it runs
from the repository root::

    JAX_PLATFORMS=cpu python tests/torch_demo_jax.py --seeds 0-7 \\
        --out ips_tpu_torch/results/demo/jax_cpu.json

``train_jax(steps, seed)`` is the JAX script's loop at draw ``seed``:
``make_task`` from ``default_rng(seed)``, the config's ``seed`` for the
initial weights and ``PRNGKey(seed)`` folded with each step; draw 0 is
the script as shipped. The config is read from the script's own source
(``jax_demo_config``), so it cannot drift from it. The command line runs
each seed's 60 steps and writes every step's loss, the last-10-step mean
and the kept indices, per seed, to ``--out``.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import time

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SCRIPT = os.path.join(REPO, "examples", "minimal_ips.py")
NOTEBOOK = os.path.join(REPO, "examples", "ips_example.ipynb")
N_SAMPLES, PATCH = 64, 32


def config_literal(source: str) -> dict:
    """The dict literal a source passes to ``config_from_dict``."""
    for node in ast.walk(ast.parse(source)):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "id", "") == "config_from_dict"):
            return eval(compile(ast.Expression(node.args[0]), "<config>",
                                "eval"), {"dict": dict})
    raise AssertionError("no config_from_dict call")


def jax_demo_config() -> dict:
    """The config literal of the JAX script."""
    with open(SCRIPT) as f:
        return config_literal(f.read())


def train_jax(steps: int, seed: int = 0, overrides=None, on_init=None):
    """The JAX script's loop at draw ``seed`` (module docstring), with
    ``overrides`` on its config; ``on_init(trainer)`` sees the trainer
    before its first step. Returns the per-step losses and batch
    accuracies and sample 0's kept indices."""
    import jax
    import jax.numpy as jnp

    from examples.minimal_ips import make_task
    from ips_tpu.config import config_from_dict
    from ips_tpu.train.schedule import warmup_cosine_lr
    from ips_tpu.train.steps import IPSTrainer
    conf = config_from_dict(dict(jax_demo_config(), seed=seed,
                                 **(overrides or {})))
    rng_np = np.random.default_rng(seed)
    X, y = make_task(rng_np, N_SAMPLES, conf.n_class, conf.N, PATCH)
    trainer = IPSTrainer(conf)
    if on_init is not None:
        on_init(trainer)
    key = jax.random.PRNGKey(seed)
    mask = jnp.ones((conf.B, conf.N), bool)
    weights = jnp.ones((conf.B,), jnp.float32)
    losses, accs = [], []
    for step in range(steps):
        sel = rng_np.integers(0, len(X), conf.B)
        labels = {"cls": jnp.asarray(y[sel], jnp.int32)}
        lr = warmup_cosine_lr(step + 1, steps, 1, 0.1, conf.lr)
        loss, _, preds = trainer.fused_step(
            jnp.asarray(X[sel]), mask, labels, weights,
            jax.random.fold_in(key, step), lr)
        losses.append(float(loss))
        accs.append(float((jnp.argmax(preds["cls"], -1)
                           == labels["cls"]).mean()))
    _, _, mem_idx, _ = trainer.select(jnp.asarray(X[:1]), rng=key)
    return {"losses": losses, "accs": accs,
            "kept": np.asarray(mem_idx)[0].tolist()}


def _seeds(text: str) -> list:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", default="0-7")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    res = {"steps": a.steps, "seeds": {}}
    for s in _seeds(a.seeds):
        t0 = time.perf_counter()
        r = train_jax(a.steps, s)
        r["last10_mean"] = float(np.mean(r["losses"][-10:]))
        r["seconds"] = time.perf_counter() - t0
        res["seeds"][str(s)] = r
        print(json.dumps({"seed": s, "last10_mean": r["last10_mean"],
                          "final_loss": r["losses"][-1],
                          "kept": r["kept"], "seconds": r["seconds"]}),
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

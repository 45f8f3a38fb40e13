"""The JAX package's TPU-trained MNIST checkpoints, carried to the port.
Not a test module: ``tests/test_torch_jax_checkpoints.py`` calls it, and
it runs from the repository root on the CPU::

    JAX_PLATFORMS=cpu python tests/torch_jax_checkpoints.py write \\
        [--out ips_tpu_torch/results/trained]
    JAX_PLATFORMS=cpu python tests/torch_jax_checkpoints.py calibrate \\
        --store DIR [--images 160] --out calibration_jax.json
    JAX_PLATFORMS=cpu python tests/torch_jax_checkpoints.py full-eval \\
        --store DIR --out full_eval_jax.json
    JAX_PLATFORMS=cpu python tests/torch_jax_checkpoints.py kept-fp32 \\
        --store DIR --card card.jsonl --out kept_fp32.json

``write`` restores each orbax step of ``STEPS`` with
``ips_tpu.utils.checkpoint.CheckpointManager`` (which restores only a
directory's latest step, so each step is copied alone into a temporary
directory first) and writes it as a flat reference-named ``.npz`` whose
arrays are the restored leaves exactly as stored (fp32 arrays, int32
counts): ``params/...`` and ``batch_stats/...`` (the names of
``ips_tpu_torch.weights.flatten_variables``) and, for a train state,
optax's ``inject_hyperparams(adamw)`` state as ``opt_state/count``,
``opt_state/hyperparams/<name>``, ``opt_state/inner_state/0/count``,
``opt_state/inner_state/0/mu/<path>`` and ``.../nu/<path>``, with the
``TrainState`` ``step`` and the checkpoint's ``epoch``. Beside them goes
``manifest.json``: each file's source step and epoch, the overrides of
the run it continues or is evaluated under (``RUN_KEYS`` as its log's
"Used config" header gives them), the log and ``n_epoch`` of the run
that wrote it (the schedule its stored lr follows) and the TPU record
lines it is held against.

``calibrate`` runs the JAX package's ``evaluate`` over the first
``--images`` test images of a store (the shipped one: 1000 test images
of the sklearn digits at 1500x1500, seed 0), from ``mnist40_e44`` and
``mnist150_e150``, under each run's overrides and again in fp32, and
its ``Predictor`` (selection without shuffle) under the run's
overrides: per image, each task's prediction and each kept set.
``kept-fp32`` takes the card's lines of ``trained_eval eval --against``
and, for each image whose kept set parted from JAX's where the card saw
no near tie (bound (iv)), runs both packages' Predictors on the CPU in
fp32 and in the run's dtype on those images.
``full-eval`` is ``evaluate`` from ``mnist40_e44`` over the whole test
split under the int8 probe's overrides (``input_dtype=bfloat16``), to
be held against ``results/int8_trained_probe.json``'s bf16 metrics.
Both run one step a dispatch (``steps_per_dispatch=1``): XLA's CPU
backend runs the K-step scan far slower a step, and K changes no
output.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
for _p in (REPO, TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

CONFIG = os.path.join(REPO, "config", "mnist_config.yml")
OUT = os.path.join(REPO, "ips_tpu_torch", "results", "trained")
# what decides a run's numerics, read from its log's config header
RUN_KEYS = ("n_epoch", "compute_dtype", "input_dtype", "sparse_input",
            "steps_per_dispatch", "eval_reuse_emb", "select_dtype",
            "score_impl", "use_pallas")
# file -> (orbax step directory, "weights" or "train", the log of the run
# whose overrides it is used under, the log of the run that wrote it, its
# TPU records: (file, epochs)). ckpt_mnist40/44 was written by the resume
# to n_epoch 44 and continued by the resume to 46, whose overrides it
# takes; its eval record is the 44-epoch run's last test line (the int8
# probe's bf16 metrics are the same values)
STEPS = {
    "mnist150_e150": ("ckpt_mnist150/150", "weights",
                      "results/mnist_150epoch_tpu.log",
                      "results/mnist_150epoch_tpu.log",
                      [("results/mnist_150epoch_metrics.jsonl", [149])]),
    "mnist150_e100": ("ckpt_mnist150/100", "train",
                      "results/mnist_150epoch_tpu.log",
                      "results/mnist_150epoch_tpu.log",
                      [("results/mnist_150epoch_metrics.jsonl",
                        [100, 101])]),
    "mnist40_e44": ("ckpt_mnist40/44", "train",
                    "results/mnist_resume46_tpu.log",
                    "results/mnist_resume44_tpu.log",
                    [("results/int8_trained_probe.json", None),
                     ("results/mnist_resume44_metrics.jsonl", [43]),
                     ("results/mnist_resume46_metrics.jsonl", [44, 45])]),
}
FP32 = {"compute_dtype": "float32", "input_dtype": "float32"}


def log_overrides(log_path: str) -> dict:
    """``RUN_KEYS`` of the "Used config:" header of a run's log."""
    with open(os.path.join(REPO, log_path)) as f:
        text = f.read()
    start = text.index("{", text.index("Used config:"))
    header, _ = json.JSONDecoder().raw_decode(text, start)
    return {k: header[k] for k in RUN_KEYS if k in header}


def record_lines(path: str, epochs) -> list:
    """``"file:line"`` of each record the file is held against."""
    if epochs is None:
        return [path]
    with open(os.path.join(REPO, path)) as f:
        return [f"{path}:{i}" for i, line in enumerate(f, 1)
                if json.loads(line)["epoch"] in epochs]


def jax_config(overrides: dict):
    from ips_tpu.config import load_config
    return load_config(CONFIG, [f"{k}={json.dumps(v)}"
                                for k, v in overrides.items()])


def restore_step(source: str, overrides: dict):
    """(JAX trainer, epoch) restored from the orbax step directory
    ``source`` (relative to the repository root), copied alone into a
    temporary directory so that the manager's latest step is this one."""
    import jax

    from ips_tpu.train.steps import IPSTrainer
    from ips_tpu.utils.checkpoint import CheckpointManager
    trainer = IPSTrainer(jax_config(overrides), rng=jax.random.PRNGKey(0))
    with tempfile.TemporaryDirectory() as tmp:
        step = os.path.basename(source)
        shutil.copytree(os.path.join(REPO, source), os.path.join(tmp, step))
        epoch = CheckpointManager(tmp).restore(trainer)
    if epoch != int(step):
        raise AssertionError(f"{source} restored epoch {epoch}")
    return trainer, epoch


def _walk(prefix: str, tree, out: dict) -> None:
    for k, v in tree.items():
        if hasattr(v, "items"):
            _walk(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def flat_state(trainer, epoch: int, kind: str) -> dict:
    """The restored state as the ``.npz``'s flat dict (module docstring)."""
    st = trainer.state
    flat: dict = {}
    _walk("params", st.params, flat)
    _walk("batch_stats", st.batch_stats, flat)
    if kind == "weights":
        return flat
    opt = st.opt_state
    adam = opt.inner_state[0]
    for later in opt.inner_state[1:]:          # adamw's weight decay, lr
        if later != type(later)():
            raise AssertionError(f"unexpected optimizer state {later}")
    if getattr(opt, "hyperparams_states", {}):
        raise AssertionError("unexpected hyperparameter states")
    flat["opt_state/count"] = np.asarray(opt.count)
    for k, v in opt.hyperparams.items():
        flat[f"opt_state/hyperparams/{k}"] = np.asarray(v)
    flat["opt_state/inner_state/0/count"] = np.asarray(adam.count)
    _walk("opt_state/inner_state/0/mu", adam.mu, flat)
    _walk("opt_state/inner_state/0/nu", adam.nu, flat)
    flat["step"] = np.asarray(st.step)
    flat["epoch"] = np.asarray(epoch)
    return flat


def n_leaves(trainer, kind: str) -> int:
    """The restored state's leaf count, the ``.npz``'s array count less
    ``epoch``, which the manager returns beside the state."""
    import jax
    st = trainer.state
    trees = [st.params, st.batch_stats]
    if kind == "train":
        trees += [st.opt_state, st.step]
    return len(jax.tree_util.tree_leaves(trees))


def write(out_dir: str = OUT) -> dict:
    """Every ``STEPS`` file and ``manifest.json``; returns the manifest."""
    os.makedirs(out_dir, exist_ok=True)
    manifest = {}
    for name, (source, kind, log, writer, records) in STEPS.items():
        over = log_overrides(log)
        trainer, epoch = restore_step(source, over)
        np.savez(os.path.join(out_dir, f"{name}.npz"),
                 **flat_state(trainer, epoch, kind))
        manifest[name] = {
            "file": f"{name}.npz", "source": source, "epoch": epoch,
            "state": ("params and batch_stats" if kind == "weights" else
                      "params, batch_stats, opt_state, step, epoch"),
            "run_log": log, "overrides": over, "written_by": writer,
            "written_n_epoch": log_overrides(writer)["n_epoch"],
            "records": sum((record_lines(p, e) for p, e in records), [])}
        print(json.dumps({name: manifest[name]}), flush=True)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return manifest


def manifest(out_dir: str = OUT) -> dict:
    with open(os.path.join(out_dir, "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------- calibration
def jax_evaluate(trainer, conf, store: str, images: int) -> dict:
    """``ips_tpu.train.loop.evaluate`` over the first ``images`` test
    images: each task's metric and mean loss, and each image's
    predictions."""
    from ips_tpu.data.loader import DataLoader
    from ips_tpu.data.mnist import MegapixelMNIST
    from ips_tpu.train.loop import evaluate
    from ips_tpu.train.metrics import MetricsLogger
    from ips_tpu_torch.scripts.trained_eval import First, image_predictions
    conf = conf.replace(data_dir=store)
    test = First(MegapixelMNIST(conf, train=False), images)
    loader = DataLoader(test, batch_size=conf.B_seq, shuffle=False,
                        num_workers=conf.n_worker)
    logger = MetricsLogger(conf.task_list)
    t0 = time.perf_counter()
    evaluate(trainer, loader, logger, conf)
    preds = image_predictions(conf, {k: np.asarray(v) for k, v in
                                     logger.y_preds.items()})
    logger.compute_metric()
    return {"images": len(test), "seconds": time.perf_counter() - t0,
            "metrics": logger.latest(),
            "loss": {t.name: logger.losses_epoch[t.name][-1]
                     for t in conf.task_list},
            "predictions": preds}


def jax_predict(trainer, conf, store: str, images: int) -> dict:
    """The JAX ``Predictor`` (selection without shuffle) over the first
    ``images`` test images, B_seq at a time: each image's predictions
    and kept set (sorted)."""
    from ips_tpu.data.mnist import MegapixelMNIST
    from ips_tpu.infer import Predictor
    from ips_tpu_torch.scripts.trained_eval import image_predictions
    conf = conf.replace(data_dir=store, sparse_input=False)
    test = MegapixelMNIST(conf, train=False)
    pred = Predictor(conf, trainer=trainer)
    kept, probs = [], {t.name: [] for t in conf.task_list}
    for lo in range(0, min(images, len(test)), conf.B_seq):
        x = np.stack([test[i]["input"] for i in
                      range(lo, min(lo + conf.B_seq, images))])
        out = pred.predict(x.astype(np.float32))
        kept.extend(np.sort(out["selected_idx"], 1).tolist())
        for t in conf.task_list:
            probs[t.name].extend(np.asarray(out[t.name]).tolist())
    return {"predictions": image_predictions(
                conf, {k: np.asarray(v) for k, v in probs.items()}),
            "kept": kept}


def calibrate(store: str, images: int) -> dict:
    """``calibrate`` (module docstring): {file: {variant: result}}."""
    from ips_tpu_torch.scripts import trained_eval as te
    man = manifest()
    out = {}
    for name in ("mnist40_e44", "mnist150_e150"):
        run = dict(man[name]["overrides"], steps_per_dispatch=1)
        if name == "mnist40_e44":
            run.update(te.PROBE_OVERRIDES)
        res = {}
        for variant, over in (("run", run), ("fp32", dict(run, **FP32))):
            trainer, _ = restore_step(man[name]["source"], over)
            conf = jax_config(over)
            res[variant] = jax_evaluate(trainer, conf, store, images)
            res[variant]["overrides"] = over
            if variant == "run":
                res["predictor"] = jax_predict(trainer, conf, store, images)
            print(json.dumps({"file": name, "variant": variant,
                              "metrics": res[variant]["metrics"],
                              "loss": res[variant]["loss"],
                              "seconds": res[variant]["seconds"]}),
                  flush=True)
        out[name] = res
    return out


def full_eval(store: str) -> dict:
    """``full-eval`` (module docstring)."""
    from ips_tpu_torch.scripts.trained_eval import PROBE_OVERRIDES
    over = dict(manifest()["mnist40_e44"]["overrides"], steps_per_dispatch=1,
                **PROBE_OVERRIDES)
    trainer, _ = restore_step(STEPS["mnist40_e44"][0], over)
    res = jax_evaluate(trainer, jax_config(over), store, 10 ** 9)
    res["overrides"] = over
    return res


def kept_in_fp32(store: str, card_path: str) -> dict:
    """For each image whose card kept set parted from the JAX Predictor's
    where the card's own bf16-against-fp32 replay found no near tie
    (bound (iv) in ``card_path``, ``trained_eval eval --against``'s
    lines): the patches each side kept alone, whether they are blank,
    and whether the kept sets of the JAX Predictor and the port's on the
    CPU, in fp32 and in the run's dtype, equal the card's."""
    from ips_tpu.infer import Predictor as JPredictor
    from ips_tpu_torch.data.mnist import MegapixelMNIST
    from ips_tpu_torch.infer import Predictor
    from ips_tpu_torch.scripts import trained_eval as te
    smoke = te.chip_smoke()
    with open(card_path) as f:
        lines = [json.loads(x) for x in f]
    out = {}
    for line in lines:
        if "against_jax" not in line:
            continue
        name = line["file"]
        jax_kept = calibration_file()[name]["predictor"]["kept"]
        card_kept = line["predictor"]["kept"]
        imgs = sorted(int(i) for i, t in
                      line["against_jax"]["kept_differ"].items()
                      if not t["near_tie"])
        if not imgs:
            continue
        conf = te.file_config(smoke, name, store, sparse_input=False)
        test = MegapixelMNIST(conf, train=False)
        x = np.stack([test[i]["input"] for i in imgs]).astype(np.float32)
        res = {"images": imgs, "card_only": [], "jax_only": [],
               "blank": []}
        for k, i in enumerate(imgs):
            c, j = set(card_kept[i]), set(jax_kept[i])
            res["card_only"].append(sorted(c - j))
            res["jax_only"].append(sorted(j - c))
            res["blank"].append([bool((x[k, p] == 0).all())
                                 for p in sorted(c ^ j)])
        run = dict(manifest()[name]["overrides"], steps_per_dispatch=1,
                   sparse_input=False)
        for variant, over in (("run", run), ("fp32", dict(run, **FP32))):
            trainer, _ = restore_step(manifest()[name]["source"], over)
            jk = np.sort(JPredictor(jax_config(over), trainer=trainer)
                         .predict(x)["selected_idx"], 1).tolist()
            tconf = conf.replace(**{k: over[k] for k in FP32})
            tk = np.sort(Predictor(tconf, trainer=te.trainer_from(
                tconf, name, "cpu")).predict(x)["selected_idx"], 1).tolist()
            res[f"jax_{variant}_equals_card"] = [
                jk[k] == card_kept[i] for k, i in enumerate(imgs)]
            res[f"port_cpu_{variant}_equals_card"] = [
                tk[k] == card_kept[i] for k, i in enumerate(imgs)]
        out[name] = res
        print(json.dumps({name: res}), flush=True)
    return out


def calibration_file() -> dict:
    with open(os.path.join(OUT, "calibration", "jax_cpu_160.json")) as f:
        return json.load(f)


def main(argv=None) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("write")
    w.add_argument("--out", default=OUT)
    c = sub.add_parser("calibrate")
    c.add_argument("--store", required=True)
    c.add_argument("--images", type=int, default=160)
    c.add_argument("--out", required=True)
    f = sub.add_parser("full-eval")
    f.add_argument("--store", required=True)
    f.add_argument("--out", required=True)
    k = sub.add_parser("kept-fp32")
    k.add_argument("--store", required=True)
    k.add_argument("--card", required=True)
    k.add_argument("--out", required=True)
    a = p.parse_args(argv)
    if a.cmd == "write":
        write(a.out)
        return 0
    res = (calibrate(a.store, a.images) if a.cmd == "calibrate"
           else full_eval(a.store) if a.cmd == "full-eval"
           else kept_in_fp32(a.store, a.card))
    with open(a.out, "w") as fh:
        json.dump(res, fh)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

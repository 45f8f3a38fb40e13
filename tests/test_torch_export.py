"""The port's serving export (ips_tpu_torch/export.py): the program that
torch.export traces from the Predictor against the live Predictor, and
against the JAX package's exported predictor.

On the CPU the exported program runs the same operators as the live
Predictor, so their outputs are held bitwise equal (measured: equal).
Against JAX's exported program, on weights carried across by the weight
bridge: the selected indices equal and the probabilities within
test_torch_infer.py's Predictor tolerance, rtol 1e-4 / atol 1e-5.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.export import ExportedPredictor as JExported
from ips_tpu.export import export_predictor as j_export
from ips_tpu.infer import Predictor as JPredictor
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.export import ExportedPredictor, export_predictor, main
from ips_tpu_torch.infer import Predictor
from ips_tpu_torch.ops import score_kernel as sk

from test_torch_infer import TINY, TOL, _inputs, _perturb_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT = dict(
    B=4, B_seq=4, n_class=1, is_image=False, n_chan_in=32, shuffle=False,
    n_token=1, N=0, M=8, I=8, use_pos=False, H=2, D=16, D_k=8, D_v=8,
    D_inner=32, compute_dtype="float32", mask_padding=True,
    tasks={"task0": {"id": 0, "name": "metastases", "act_fn": "sigmoid",
                     "metric": "auc"}})
N_ITER = -(-(TINY["N"] - TINY["M"]) // TINY["I"])   # score_logits nodes


@pytest.fixture(scope="module")
def live():
    return Predictor(t_config(dict(TINY)), device="cpu")


@pytest.fixture(scope="module")
def artifact(live, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "model.pt2")
    torch.export.save(export_predictor(live, batch_size=TINY["B"]), path)
    return path


def _assert_equal(out, ref):
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_exported_matches_live_image_mode(live, artifact):
    model = ExportedPredictor.load(artifact)
    assert (model.batch_size, model.n_patches) == (TINY["B"], TINY["N"])
    assert model.device == torch.device("cpu")
    x = _inputs(2)
    mask = np.ones((2, TINY["N"]), bool)
    mask[1, -6:] = False
    for m in (None, mask):
        _assert_equal(model.predict(x, m), live.predict(x, m))


def test_exported_feature_mode_with_mask(tmp_path):
    conf = t_config(dict(FEAT))
    live = Predictor(conf, device="cpu")
    n = 20
    path = str(tmp_path / "feat.pt2")
    torch.export.save(export_predictor(live, batch_size=conf.B,
                                       n_patches=n), path)
    model = ExportedPredictor.load(path)
    x = np.random.default_rng(2).normal(0, 1, (conf.B, n, 32)).astype(
        np.float32)
    mask = np.ones((conf.B, n), bool)
    mask[:, 15:] = False
    mask[1, 9:] = False
    out = model.predict(x, mask)
    _assert_equal(out, live.predict(x, mask))
    assert out["selected_idx"].shape == (conf.B, conf.M)
    with pytest.raises(ValueError, match="n_patches is required"):
        export_predictor(live, batch_size=conf.B)


def test_exported_rejects_wrong_shape(artifact):
    model = ExportedPredictor.load(artifact)
    with pytest.raises(ValueError, match="re-export"):
        model.predict(_inputs(2, B=1))
    with pytest.raises(ValueError, match="re-export"):
        model.predict(_inputs(2)[:, :-1])


def test_graph_holds_the_score_logits_op(artifact):
    program = torch.export.load(artifact)
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.ips_tpu_torch.score_logits.default) == N_ITER
    # the weights are the program's state
    assert "model.encoder.conv1.weight" in program.state_dict


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementation_shape(dtype):
    with FakeTensorMode() as mode:
        x = torch.empty((3, 37, 16), dtype=dtype)
        w = torch.empty((16, 12), dtype=dtype)
        out = torch.ops.ips_tpu_torch.score_logits(x, w)
    assert out.shape == (3, 37, 12) and out.dtype == torch.float32
    assert out.fake_mode is mode
    # the CPU implementation is the plain version, and counts no launch
    before = sk.logits.launches
    x, w = torch.randn(3, 37, 16), torch.randn(16, 12)
    torch.testing.assert_close(torch.ops.ips_tpu_torch.score_logits(x, w),
                               sk.plain_logits(x, w), rtol=0, atol=0)
    assert sk.logits.launches == before


def test_fresh_process_runs_the_artifact(live, artifact, tmp_path):
    """A process that imports only the op's module loads and runs it."""
    x = _inputs(3)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys, numpy as np, torch\n"
        "import ips_tpu_torch.ops.score_kernel\n"
        f"ep = torch.export.load({artifact!r})\n"
        f"x = torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))\n"
        "m = torch.ones(x.shape[:2], dtype=torch.bool)\n"
        "with torch.no_grad():\n"
        "    out = ep.module()(x, m)\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, "
        "**{k: v.numpy() for k, v in out.items()})\n"
        "assert 'ips_tpu_torch.infer' not in sys.modules\n"
        "assert 'ips_tpu_torch.models.ips_net' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(tmp_path), timeout=120)
    with np.load(tmp_path / "out.npz") as f:
        _assert_equal(dict(f), live.predict(x))


def test_cli_selftest(tmp_path, capsys):
    cfg = tmp_path / "conf.json"
    cfg.write_text(json.dumps(TINY))
    pred = Predictor(t_config(dict(TINY)), device="cpu")
    ckpt = str(tmp_path / "w.pt")
    torch.save(pred.trainer.model.state_dict(), ckpt)
    out = str(tmp_path / "m.pt2")
    main(["--config", str(cfg), "--checkpoint", ckpt, "--output", out,
          "--batch", "2", "--device", "cpu", "--selftest"])
    text = capsys.readouterr().out
    assert "selftest ok" in text and "(bitwise equal)" in text
    model = ExportedPredictor.load(out)
    _assert_equal(model.predict(_inputs(4)), pred.predict(_inputs(4)))


def test_module_cli_runs(tmp_path):
    """``python -m ips_tpu_torch.export --device cpu --selftest``."""
    cfg = tmp_path / "conf.json"
    conf = dict(TINY, N=12, M=4, I=4)
    cfg.write_text(json.dumps(conf))
    ckpt = str(tmp_path / "w.pt")
    torch.save(Predictor(t_config(conf), device="cpu").trainer.model
               .state_dict(), ckpt)
    out = tmp_path / "m.pt2"
    proc = subprocess.run(
        [sys.executable, "-m", "ips_tpu_torch.export", "--config", str(cfg),
         "--checkpoint", ckpt, "--output", str(out), "--batch", "2",
         "--device", "cpu", "--selftest"], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO), cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "selftest ok" in proc.stdout and out.exists()


def test_exported_matches_jax_export():
    """The exported port against JAX's exported predictor, on the JAX
    trainer's weights (perturbed running statistics)."""
    jtr = JTrainer(j_config(dict(TINY)), rng=jax.random.PRNGKey(0),
                   init_opt=False)
    stats = _perturb_stats(jtr.state.batch_stats, np.random.default_rng(1))
    jtr.state = jtr.state.replace(
        batch_stats=jax.tree_util.tree_map(jax.numpy.asarray, stats))
    jp = JPredictor(j_config(dict(TINY)), trainer=jtr)
    tp = Predictor(t_config(dict(TINY)), device="cpu")
    weights.load_jax(tp.trainer.model, jtr.state.params,
                     jtr.state.batch_stats)
    jm = JExported(j_export(jp, batch_size=TINY["B"]))
    tm = ExportedPredictor(export_predictor(tp, batch_size=TINY["B"]))
    x = _inputs(5)
    a, b = jm.predict(x), tm.predict(x)
    np.testing.assert_array_equal(b["selected_idx"], a["selected_idx"])
    for name in ("majority", "multi"):
        np.testing.assert_allclose(b[name], a[name], **TOL)

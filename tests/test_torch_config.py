"""The port's config copy and the chip smoke script's config literal."""

import importlib.util
import os

import pytest
import yaml

from ips_tpu.config import load_config as j_load
from ips_tpu_torch.config import config_from_dict, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_literal_equals_mnist_yaml():
    path = os.path.join(REPO, "config", "mnist_config.yml")
    with open(path) as f:
        assert _smoke_module().MNIST_CONFIG == yaml.safe_load(f)
    assert config_from_dict(_smoke_module().MNIST_CONFIG) == load_config(path)


def test_smoke_literal_equals_camelyon_yaml():
    path = os.path.join(REPO, "config", "camelyon_config.yml")
    with open(path) as f:
        assert _smoke_module().CAMELYON_CONFIG == yaml.safe_load(f)
    assert config_from_dict(_smoke_module().CAMELYON_CONFIG) == \
        load_config(path)


def test_smoke_literal_equals_camelyon_e2e_yaml():
    path = os.path.join(REPO, "config", "camelyon_e2e_config.yml")
    with open(path) as f:
        assert _smoke_module().CAMELYON_E2E_CONFIG == yaml.safe_load(f)
    assert config_from_dict(_smoke_module().CAMELYON_E2E_CONFIG) == \
        load_config(path)


def test_smoke_literal_equals_traffic_yaml():
    path = os.path.join(REPO, "config", "traffic_config.yml")
    with open(path) as f:
        assert _smoke_module().TRAFFIC_CONFIG == yaml.safe_load(f)
    assert config_from_dict(_smoke_module().TRAFFIC_CONFIG) == \
        load_config(path)


@pytest.mark.parametrize("name", ["mnist_config.yml", "traffic_config.yml",
                                  "camelyon_config.yml",
                                  "camelyon_e2e_config.yml"])
def test_same_fields_as_reference(name):
    path = os.path.join(REPO, "config", name)
    ours, ref = load_config(path), j_load(path)
    assert ours.to_dict() == ref.to_dict()


def test_overrides_and_json(tmp_path):
    path = os.path.join(REPO, "config", "mnist_config.yml")
    conf = load_config(path, ["M=50", "compute_dtype=float32"])
    assert (conf.M, conf.compute_dtype) == (50, "float32")
    js = tmp_path / "c.json"
    js.write_text(__import__("json").dumps(_smoke_module().MNIST_CONFIG))
    assert load_config(str(js)) == load_config(path)
    with pytest.raises(ValueError, match="key=value"):
        load_config(path, ["M"])
    with pytest.raises(ValueError, match="unknown config keys"):
        config_from_dict(dict(_smoke_module().MNIST_CONFIG, bogus=1))


@pytest.mark.parametrize("over", [
    {"mesh_data": 2, "eager": False, "sparse_input": False},
    {"mesh_data": 2, "B_seq": 8}])
def test_unported_values_raise(over):
    """The settings that raised while ROADMAP item 6 was open, streaming
    selection under a mesh and B_seq < B under several data ranks, are
    ported (item 6 closed) and build."""
    conf = config_from_dict(dict(_smoke_module().MNIST_CONFIG, **over))
    assert all(getattr(conf, k) == v for k, v in over.items())


@pytest.mark.parametrize("over", [
    {"mesh_data": 2}, {"mesh_patch": 2},
    {"mesh_data": 2, "mesh_patch": 2, "cp_select": "local_merge"},
    {"mesh_patch": 2, "B_seq": 8},
    {"multihost": True, "cpu_collectives": "gloo"}])
def test_mesh_values_build(over):
    """Data and context parallelism are ported: these settings build."""
    conf = config_from_dict(dict(_smoke_module().MNIST_CONFIG, **over))
    assert all(getattr(conf, k) == v for k, v in over.items())


def test_int8_select_config_builds():
    """select_dtype=int8 is ported: the config builds and the trainer's
    selection encode is the int8 one (models/quant.py)."""
    from ips_tpu_torch.train.steps import IPSTrainer
    conf = config_from_dict(dict(_smoke_module().MNIST_CONFIG,
                                 select_dtype="int8"))
    assert conf.select_dtype == "int8"
    tr = IPSTrainer(conf.replace(N=12, M=4, I=4), device="cpu",
                    init_opt=False)
    encode, score = tr._enc_score_fns()
    assert encode.__module__ == "ips_tpu_torch.models.quant"
    assert score == tr.model.scores


def test_feature_mode_is_accepted():
    """is_image=false builds the projector model; int8 selection stays
    the ValueError it is in the JAX package."""
    base = dict(_smoke_module().MNIST_CONFIG)
    conf = config_from_dict(dict(base, is_image=False, n_chan_in=64,
                                 sparse_input=False, use_pos=False))
    assert not conf.is_image
    with pytest.raises(ValueError, match="feature"):
        config_from_dict(dict(base, is_image=False, select_dtype="int8"))


def test_camelyon_config_loads():
    conf = load_config(os.path.join(REPO, "config", "camelyon_config.yml"))
    assert (conf.is_image, conf.n_chan_in, conf.D, conf.M, conf.B,
            conf.B_seq, conf.ln_fold) == (False, 2048, 512, 5000, 16, 1,
                                          True)


def test_validation_is_kept():
    base = dict(_smoke_module().MNIST_CONFIG)
    with pytest.raises(ValueError, match="B_seq"):
        config_from_dict(dict(base, B_seq=3))
    with pytest.raises(ValueError, match="n_token"):
        config_from_dict(dict(base, n_token=2))
    assert config_from_dict(dict(base, use_pallas=True)).score_impl == \
        "pallas"

"""Weight bridge between the JAX package's variables and the port.

The reference keeps flax variables: ``params`` and ``batch_stats`` trees
(``ips_tpu/models/ips_net.py:init_ips_model``). Here they travel as a flat
dict of numpy arrays keyed ``"<collection>/<module path>/<leaf>"``, e.g.
``"params/encoder/conv1/kernel"`` — the form of the nested trees
flattened, and of an ``.npz`` file. The port's module names mirror the
reference's, so a key maps to the port's ``state_dict`` by path, with
these leaf and layout rules:

  conv ``kernel`` (HWIO)      <-> ``weight`` (OIHW)
  Dense ``kernel`` (in, out)  <-> ``weight`` (out, in)
  BatchNorm / LayerNorm ``scale`` <-> ``weight``; ``bias`` <-> ``bias``
  ``batch_stats`` ``mean`` / ``var`` <-> ``running_mean`` / ``running_var``
  the query tokens ``q`` (1, T, D) <-> ``q``

The feature projector's tree (``encoder/fc`` and ``encoder/bn``) maps
by the same rules: its LayerNorm has no parameters on either side.
A key with no counterpart, or a counterpart with no key, raises.

The training state travels too (:func:`load_jax_train_state`): optax's
AdamW moments ``mu`` / ``nu`` are trees shaped like ``params`` and map to
``torch.optim.AdamW``'s ``exp_avg`` / ``exp_avg_sq`` by the same rules,
the Adam ``count`` to each parameter's ``step``, and ``TrainState.step``
to the trainer's step counter.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ips_tpu_torch.models.norm import MaskedBatchNorm

Flat = Dict[str, np.ndarray]


def flatten_variables(params: Mapping[str, Any],
                      batch_stats: Optional[Mapping[str, Any]] = None
                      ) -> Flat:
    """Nested ``params`` / ``batch_stats`` trees -> flat numpy dict."""
    flat: Flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(f"{prefix}/{k}", v)
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v)

    walk("params", params)
    walk("batch_stats", batch_stats or {})
    return flat


def _layout(module: nn.Module, leaf: str) -> Tuple[str, str, str]:
    """(collection, reference leaf name, layout) for a port tensor."""
    if isinstance(module, MaskedBatchNorm):
        return {"weight": ("params", "scale", ""),
                "bias": ("params", "bias", ""),
                "running_mean": ("batch_stats", "mean", ""),
                "running_var": ("batch_stats", "var", "")}[leaf]
    if isinstance(module, nn.LayerNorm):
        return {"weight": ("params", "scale", ""),
                "bias": ("params", "bias", "")}[leaf]
    if isinstance(module, nn.Conv2d) and leaf == "weight":
        return "params", "kernel", "conv"
    if isinstance(module, nn.Linear) and leaf == "weight":
        return "params", "kernel", "dense"
    return "params", leaf, ""


def _tensors(model: nn.Module):
    """(port state_dict key, reference key, layout, tensor) for every
    tensor of ``model``'s state dict."""
    for key, tensor in model.state_dict(keep_vars=True).items():
        mod_name, _, leaf = key.rpartition(".")
        coll, ref_leaf, layout = _layout(model.get_submodule(mod_name), leaf)
        parts = mod_name.split(".") if mod_name else []
        yield key, "/".join([coll, *parts, ref_leaf]), layout, tensor


def to_flat(model: nn.Module) -> Flat:
    """Port module -> flat numpy dict in the reference's names and layouts."""
    flat: Flat = {}
    for _, ref_key, layout, tensor in _tensors(model):
        t = tensor.detach().cpu().float()
        if layout == "conv":
            t = t.permute(2, 3, 1, 0)          # OIHW -> HWIO
        elif layout == "dense":
            t = t.t()                          # (out, in) -> (in, out)
        flat[ref_key] = np.ascontiguousarray(t.numpy())
    return flat


def load_flat(model: nn.Module,
              flat: Union[str, Mapping[str, np.ndarray]]) -> None:
    """Load a flat reference-named dict, or an ``.npz`` holding one, into
    ``model``; every key of each side must be matched."""
    if isinstance(flat, str):
        with np.load(flat) as z:
            flat = {k: z[k] for k in z.files}
    state = {key: _from_reference(flat, key, ref_key, layout, target)
             for key, ref_key, layout, target in _tensors(model)}
    _check_all_used(flat, {ref_key for _, ref_key, _, _ in _tensors(model)})
    model.load_state_dict(state, strict=True)


def _from_reference(flat: Mapping[str, np.ndarray], key: str, ref_key: str,
                    layout: str, target: torch.Tensor) -> torch.Tensor:
    """flat[ref_key] in the port's layout, checked against ``target``."""
    if ref_key not in flat:
        raise KeyError(f"weight bridge: {ref_key!r} (for {key!r}) is "
                       "missing from the given variables")
    t = torch.from_numpy(np.array(flat[ref_key], np.float32))
    if layout == "conv":
        t = t.permute(3, 2, 0, 1)          # HWIO -> OIHW
    elif layout == "dense":
        t = t.t()
    if t.shape != target.shape:
        raise ValueError(f"weight bridge: {ref_key!r} has shape "
                         f"{tuple(t.shape)}, {key!r} needs "
                         f"{tuple(target.shape)}")
    return t.contiguous()


def _check_all_used(flat: Mapping[str, np.ndarray], used) -> None:
    unused = sorted(set(flat) - set(used))
    if unused:
        raise KeyError(f"weight bridge: keys with no counterpart in the "
                       f"port: {unused}")


def load_jax(model: nn.Module, params: Mapping[str, Any],
             batch_stats: Mapping[str, Any]) -> None:
    """Load the reference's nested ``params`` / ``batch_stats`` trees."""
    load_flat(model, flatten_variables(params, batch_stats))


def load_adam(optimizer: torch.optim.Optimizer, model: nn.Module,
              mu: Mapping[str, Any], nu: Mapping[str, Any],
              count: int) -> None:
    """Load optax's Adam state (``ScaleByAdamState``: ``mu`` and ``nu``
    trees shaped like ``params``, and ``count``) into ``optimizer``, a
    ``torch.optim.AdamW`` over ``model.parameters()``."""
    flat_mu, flat_nu = flatten_variables(mu), flatten_variables(nu)
    used = []
    for key, ref_key, layout, target in _tensors(model):
        if not isinstance(target, nn.Parameter):
            continue
        used.append(ref_key)
        dev = target.device
        optimizer.state[target] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": _from_reference(flat_mu, key, ref_key, layout,
                                       target).to(dev),
            "exp_avg_sq": _from_reference(flat_nu, key, ref_key, layout,
                                          target).to(dev)}
    _check_all_used(flat_mu, used)
    _check_all_used(flat_nu, used)


def load_jax_train_state(trainer, state) -> None:
    """Carry the reference's ``TrainState`` (params, batch_stats,
    opt_state, step) into an ``IPSTrainer`` of the port, so that a run
    continues from it. ``state.opt_state`` is optax's
    ``inject_hyperparams(adamw)`` state, whose ``inner_state[0]`` is the
    ``ScaleByAdamState``; it is read by attribute, without optax."""
    load_jax(trainer.model, state.params, state.batch_stats)
    adam = state.opt_state.inner_state[0]
    load_adam(trainer.opt, trainer.model, adam.mu, adam.nu, int(adam.count))
    trainer.step = int(state.step)


def save_npz(model: nn.Module, path: str) -> None:
    """Write the port's weights as a flat reference-named ``.npz``."""
    np.savez(path, **to_flat(model))


def block_params_from_reference(ref: Mapping[str, np.ndarray],
                                device: Union[str, torch.device] = "cpu"
                                ) -> Dict[str, torch.Tensor]:
    """The conv probe's BasicBlock parameters (scripts/probe_conv.py:
    ``make_block_params``, as numpy arrays) -> the port's tensors, same
    names and layouts: ``w1``, ``w2`` (3, 3, c, c) HWIO stay bf16 (their
    values are exact in fp32 on the way), ``s1``, ``b1``, ``s2``, ``b2``
    (c,) fp32."""
    out = {}
    for k, a in ref.items():
        a = np.asarray(a)
        t = torch.from_numpy(np.array(a, np.float32))
        if a.dtype.name == "bfloat16":
            t = t.to(torch.bfloat16)
        out[k] = t.to(device)
    return out

"""Ranks of the CPU tests of ips_tpu_torch.parallel (not a test file).

Each function runs on one rank of a gloo world that
``ips_tpu_torch.parallel.launch.run_world`` starts, and writes what it
computed to ``<out>/rank<r>.npz`` for the test to read. It imports
nothing of JAX.
"""

import json
import os

import numpy as np
import torch
import torch.distributed as dist

BN_SHAPE = (8, 3, 5, 4)          # (rows, C, H, W)
BN_WEIGHTS = np.array([1, 0, 1, 1, 0, 1, 1, 0], np.float32)


def bn_inputs():
    """The global BatchNorm input, row weights (zero-weight rows among
    them) and the gradient of the output."""
    rng = np.random.default_rng(4)
    x = rng.normal(1.5, 2.0, BN_SHAPE).astype(np.float32)
    g = rng.normal(size=BN_SHAPE).astype(np.float32)
    return x, BN_WEIGHTS, g


def _init() -> int:
    torch.set_num_threads(1)
    from ips_tpu_torch.parallel.distributed import initialize
    assert initialize(device="cpu")       # env:// from run_world, gloo
    return dist.get_rank()


def _save(out_dir, rank, arrays):
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)


def bn(argv):
    """MaskedBatchNorm in training over this rank's rows of bn_inputs(),
    its statistics over the world: output, input gradient, running
    statistics and the local shares of the affine gradients."""
    out_dir, = argv
    r = _init()
    from ips_tpu_torch.models.norm import MaskedBatchNorm
    x, w, g = bn_inputs()
    k = x.shape[0] // dist.get_world_size()
    rows = slice(r * k, (r + 1) * k)
    norm = MaskedBatchNorm(x.shape[1])
    with torch.no_grad():
        norm.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
        norm.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[1]))
    norm.group = dist.new_group(list(range(dist.get_world_size())))
    xt = torch.from_numpy(x[rows]).requires_grad_(True)
    y = norm(xt, use_running_average=False,
             weights=torch.from_numpy(w[rows]))
    (y * torch.from_numpy(g[rows])).sum().backward()
    _save(out_dir, r, {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
                       "mean": norm.running_mean.numpy(),
                       "var": norm.running_var.numpy(),
                       "dweight": norm.weight.grad.numpy(),
                       "dbias": norm.bias.grad.numpy()})


def _opt_state(opt):
    return {f"opt/{i}/{k}": v.detach().cpu().numpy()
            for i, s in enumerate(opt.state.values())
            for k, v in s.items() if isinstance(v, torch.Tensor)}


def train(argv):
    """Over a data x patch mesh, from the weights in ``case_dir``: the
    selection of the batch, one fused dense step, one fused sparse step,
    and a fused step with dropout and instance shuffle on; with a patch
    axis of 2, also the local-merge selection."""
    case_dir, data, patch = argv[0], int(argv[1]), int(argv[2])
    r = _init()
    from ips_tpu_torch import weights
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.parallel.ips_sharded import ShardedIPSTrainer
    with open(os.path.join(case_dir, "conf.json")) as f:
        case = json.load(f)
    b = dict(np.load(os.path.join(case_dir, "batch.npz")))
    labels = {k[len("label/"):]: v for k, v in b.items()
              if k.startswith("label/")}
    hw = tuple(int(v) for v in b["img_hw"])

    def trainer(**over):
        tr = ShardedIPSTrainer(config_from_dict(dict(
            case["conf"], mesh_data=data, mesh_patch=patch, **over)),
            device="cpu")
        weights.load_flat(tr.model, os.path.join(case_dir, "weights.npz"))
        return tr, tr.put_batch({
            "p": b["patches"], "m": b["mask"], "w": b["weights"],
            "idx": b["flat_idx"], "val": b["values"], "lab": labels})

    def record(tag, tr, res):
        loss, task_losses, preds = res
        out[f"{tag}/loss"] = loss.numpy()
        out.update({f"{tag}/preds/{k}": v.numpy() for k, v in preds.items()})
        out.update({f"{tag}/{k}": v for k, v in
                    weights.to_flat(tr.model).items()})
        out.update({f"{tag}/{k}": v for k, v in _opt_state(tr.opt).items()})

    out = {}
    tr, q = trainer()
    out["idx"] = tr.select(q["p"], q["m"])[2].numpy()
    record("dense", tr, tr.fused_step(q["p"], q["m"], q["lab"], q["w"],
                                      tr.new_generator(0), case["lr"]))
    tr, q = trainer()
    record("sparse", tr, tr.fused_sparse_step(
        q["idx"], q["val"], hw, q["m"], q["lab"], q["w"],
        tr.new_generator(0), case["lr"]))
    tr, q = trainer(**case["random"])
    out["random/idx"] = tr.select(q["p"], q["m"],
                                  tr.new_generator(7))[2].numpy()
    record("random", tr, tr.fused_step(q["p"], q["m"], q["lab"], q["w"],
                                       tr.new_generator(7), case["lr"]))
    if patch == 2:
        tr, q = trainer(cp_select="local_merge", M=case["merge_M"])
        out["merge/idx"] = tr.select(q["p"], q["m"])[2].numpy()
    _save(case_dir, f"{data}x{patch}_{r}", out)


def cli(argv):
    """The training CLI on this rank; its final weights, AdamW state, step
    and the checkpoints it saved."""
    config, out_dir = argv
    torch.set_num_threads(1)
    from ips_tpu_torch import weights
    from ips_tpu_torch.main import main
    from ips_tpu_torch.utils.checkpoint import CheckpointManager
    saves = []
    save = CheckpointManager.save

    def counted(self, trainer, epoch):
        saves.append(epoch)
        return save(self, trainer, epoch)
    CheckpointManager.save = counted
    r = int(os.environ["RANK"])
    tr, _, _ = main(["--config", config, "--device", "cpu"])
    _save(out_dir, r, dict(weights.to_flat(tr.model), **_opt_state(tr.opt),
                           step=np.int64(tr.step),
                           saves=np.asarray(saves, np.int64)))


def collective_parts(n, device):
    """Each rank's (4, 3, 5) float32 part, and the weights its output
    gradient carries; every rank makes all of them from the seed."""
    g = torch.Generator().manual_seed(11)
    parts = [torch.randn((4, 3, 5), generator=g) for _ in range(n)]
    ws = [torch.randn((4, 3, 5), generator=g) for _ in range(n)]
    return [p.to(device) for p in parts], [w.to(device) for w in ws]


def collectives(argv):
    """On the card (``backend`` gloo or nccl): all_gather_rows along dim
    1, the BatchNorm's differentiable group sum with its backward, and
    the gradient all-reduce with a scale of 1/2."""
    out_dir, backend = argv
    from ips_tpu_torch.models.norm import _group_sum
    from ips_tpu_torch.parallel import distributed as pdist
    pdist.initialize(cpu_collectives="gloo" if backend == "gloo" else None)
    assert dist.get_backend() == backend
    r, n = dist.get_rank(), dist.get_world_size()
    dev = pdist.local_device()
    parts, ws = collective_parts(n, dev)
    gathered = pdist.all_gather_rows(parts[r], dim=1)
    t = parts[r].clone().requires_grad_(True)
    summed = _group_sum(t, dist.group.WORLD)
    (summed * ws[r]).sum().backward()
    grads = [parts[r].clone(), 2 * parts[r]]
    pdist.all_reduce_sum(grads, scale=0.5)
    torch.save({"device": str(dev), "gathered": gathered.cpu(),
                "summed": summed.detach().cpu(), "dsum": t.grad.cpu(),
                "grads": [g.cpu() for g in grads]},
               os.path.join(out_dir, f"{backend}{r}.pt"))
    dist.destroy_process_group()

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


def _case(case_dir):
    with open(os.path.join(case_dir, "conf.json")) as f:
        return json.load(f)


def _sharded(case_dir, conf, data, patch, **over):
    """A ShardedIPSTrainer over a data x patch mesh on the CPU from the
    weights in ``case_dir``."""
    from ips_tpu_torch import weights
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.parallel.ips_sharded import ShardedIPSTrainer
    tr = ShardedIPSTrainer(config_from_dict(dict(
        conf, mesh_data=data, mesh_patch=patch, **over)), device="cpu")
    weights.load_flat(tr.model, os.path.join(case_dir, "weights.npz"))
    return tr


def _record_stages(staged):
    """Record the (S, B, n) index shape of every stage the streaming
    selector gathers on the host."""
    from ips_tpu_torch.train.streaming import StreamingSelector
    host_tiles = StreamingSelector._host_tiles

    def recorded(self, patches, idx):
        staged.append(idx.shape)
        return host_tiles(self, patches, idx)
    StreamingSelector._host_tiles = recorded


def stream(argv):
    """Streaming selection (``eager: false``) over a data x patch mesh:
    this rank's rows of the batch, kept patches, embeddings, the M >= N
    shortcut and shuffled selections, and the shape of every stage."""
    case_dir, data, patch = argv[0], int(argv[1]), int(argv[2])
    r = _init()
    from ips_tpu_torch.parallel.mesh import row_range
    case = _case(case_dir)
    b = dict(np.load(os.path.join(case_dir, "batch.npz")))
    staged = []
    _record_stages(staged)
    tr = _sharded(case_dir, case["conf"], data, patch)
    lo, hi = row_range(len(b["patches"]), tr.mesh)
    x, m, short = b["patches"][lo:hi], b["mask"][lo:hi], b["short"][lo:hi]
    out = {}
    res = tr.select_streaming(x, m, tr.new_generator(0))
    out.update({"patch": res[0].numpy(), "pos": res[1].numpy(),
                "idx": res[2].numpy(), "mask": res[3].numpy(),
                "staged": np.array(staged)})
    res = tr.select_streaming(x, m, tr.new_generator(0), return_emb=True)
    out.update({"emb/idx": res[2].numpy(), "emb": res[4].numpy()})
    del staged[:]
    res = tr.select_streaming(short, None, tr.new_generator(0),
                              return_emb=True)
    out.update({"short/idx": res[2].numpy(), "short/emb": res[4].numpy(),
                "short/staged": np.array(staged)})
    for style in ("batch", "instance"):
        tr = _sharded(case_dir, case["conf"], data, patch, shuffle=True,
                      shuffle_style=style)
        out[f"shuffle/{style}"] = tr.select_streaming(
            x, m, tr.new_generator(7))[2].numpy()
    _save(case_dir, f"stream{data}x{patch}_{r}", out)


class ArrayDataset:
    """Items of a (n, N, ...) float32 array with a validity mask and the
    labels of ``label/<task>`` keys, read from an .npz."""

    def __init__(self, path):
        self.a = dict(np.load(path))

    def __len__(self):
        return len(self.a["input"])

    def __getitem__(self, i):
        return {k[len("label/"):] if k.startswith("label/") else k: v[i]
                for k, v in self.a.items()}


class _Recorder:
    """A MetricsLogger that also keeps each update's task losses and
    predictions."""

    def __init__(self, logger):
        self.logger, self.steps = logger, []

    def update(self, task_losses, preds, labels, weights=None):
        self.steps.append((dict(task_losses), dict(preds)))
        self.logger.update(task_losses, preds, labels, weights=weights)


def recorded_epoch(tr, conf, train_loader, test_loader):
    """One train epoch and one eval pass through the loop; the task
    losses and predictions of every step, stacked by step."""
    from ips_tpu_torch.train.loop import evaluate, train_one_epoch
    from ips_tpu_torch.train.metrics import MetricsLogger
    out = {}
    for split in ("train", "test"):
        rec = _Recorder(MetricsLogger(conf.task_list))
        if split == "train":
            train_one_epoch(tr, train_loader, 0, rec, conf)
        else:
            evaluate(tr, test_loader, rec, conf)
        for k in rec.steps[0][0]:
            out[f"{split}/loss/{k}"] = np.array([s[0][k] for s in rec.steps])
        for k in rec.steps[0][1]:
            out[f"{split}/preds/{k}"] = np.stack([s[1][k]
                                                  for s in rec.steps])
    return out


def assembled(argv):
    """B_seq < B over a data x patch mesh: this rank's slots of one
    optimizer batch through ``fused_assembled_step`` (K = 1), of two
    through ``fused_assembled_multi_step`` (K = 2), one step with
    dropout and instance shuffle on (and its slots' selections), and, at
    2x1, one streamed epoch and eval through the loop."""
    case_dir, data, patch = argv[0], int(argv[1]), int(argv[2])
    r = _init()
    from ips_tpu_torch import weights
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.main import build_loaders
    case = _case(case_dir)
    b = dict(np.load(os.path.join(case_dir, "slots.npz")))
    K, n_slots = b["patches"].shape[:2]
    d = r // patch
    r_loc = n_slots // data
    mine = slice(d * r_loc, (d + 1) * r_loc)
    rows = slice(d * r_loc * b["patches"].shape[2],
                 (d + 1) * r_loc * b["patches"].shape[2])
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    p, m, w = t["patches"][:, mine], t["mask"][:, mine], t["weights"][:, rows]
    lab = {k[len("label/"):]: v[:, rows] for k, v in t.items()
           if k.startswith("label/")}
    seeds = b["seeds"][:, mine].tolist()
    out = {}

    def record(tag, tr, res):
        loss, task_losses, preds = res
        out[f"{tag}/loss"] = loss.numpy()
        out.update({f"{tag}/preds/{k}": v.numpy() for k, v in preds.items()})
        out.update({f"{tag}/{k}": v for k, v in
                    weights.to_flat(tr.model).items()})
        out.update({f"{tag}/{k}": v for k, v in _opt_state(tr.opt).items()})

    for tag, over in (("k1", {}), ("random", case["random"])):
        tr = _sharded(case_dir, case["conf"], data, patch, **over)
        gen = tr.new_generator
        if tag == "random":
            with torch.no_grad():
                out["random/idx"] = tr._select_slots(
                    p[0], m[0], [gen(s) for s in seeds[0]])[2].numpy()
        record(tag, tr, tr.fused_assembled_step(
            p[0], m[0], {k: v[0] for k, v in lab.items()}, w[0],
            [gen(s) for s in seeds[0]], gen(int(b["train_seeds"][0])),
            case["lr"]))
    tr = _sharded(case_dir, case["conf"], data, patch)
    gen = tr.new_generator
    record("k2", tr, tr.fused_assembled_multi_step(
        p, m, lab, w, [[gen(s) for s in ss] for ss in seeds],
        [gen(int(s)) for s in b["train_seeds"]], [case["lr"]] * K))
    if patch == 1:
        from ips_tpu_torch.parallel.ips_sharded import ShardedIPSTrainer
        conf = config_from_dict(dict(case["conf"], **case["streamed"],
                                     mesh_data=data))
        tr = ShardedIPSTrainer(conf, device="cpu")
        weights.load_flat(tr.model, os.path.join(case_dir, "weights.npz"))
        ds = ArrayDataset(os.path.join(case_dir, "items.npz"))
        train_loader, test_loader = build_loaders(conf, ds, ds, d, data)
        epoch = recorded_epoch(tr, conf, train_loader, test_loader)
        out.update({f"streamed/{k}": v for k, v in epoch.items()})
        out.update({f"streamed/{k}": v for k, v in
                    weights.to_flat(tr.model).items()})
    _save(case_dir, f"asm{data}x{patch}_{r}", out)


def e2e_slides(spec):
    """The tiny camelyon_e2e corpus of ``spec`` (train and test tile
    counts, tile size), in memory."""
    from ips_tpu_torch.data.camelyon.patches import synth_tile_slides
    hw = tuple(spec["tile_hw"])
    return (synth_tile_slides(spec["train"], hw, seed=0),
            synth_tile_slides(spec["test"], hw, seed=1))


def driver(argv):
    """The training driver on this rank: ``--dataset camelyon`` through
    the CLI, or ``camelyon_e2e`` through ``main.run`` on the in-memory
    corpus of ``<config dir>/slides.json``; the final weights, AdamW
    state and step."""
    dataset, config, out_dir = argv
    torch.set_num_threads(1)
    from ips_tpu_torch import weights
    from ips_tpu_torch.main import main, run
    r = int(os.environ["RANK"])
    if dataset == "camelyon":
        tr, _, _ = main(["--dataset", dataset, "--config", config,
                         "--device", "cpu"])
    else:
        from ips_tpu_torch.config import load_config
        from ips_tpu_torch.data.camelyon.patches import CamelyonPatches
        conf = load_config(config)
        with open(os.path.join(os.path.dirname(config), "slides.json")) as f:
            train, test = e2e_slides(json.load(f))
        tr, _, _ = run(conf, dataset, "cpu", datasets=(
            CamelyonPatches(conf, True, slides=train),
            CamelyonPatches(conf, False, slides=test)))
        dist.destroy_process_group()
    _save(out_dir, r, dict(weights.to_flat(tr.model), **_opt_state(tr.opt),
                           step=np.int64(tr.step)))


CARD_STREAM = dict(
    B=1, B_seq=1, n_class=1, is_image=True, enc_type="resnet18",
    n_chan_in=3, n_res_blocks=2, n_token=1, N=0, M=8, I=8,
    patch_size=[32, 32], patch_stride=[32, 32], use_pos=False, H=2, D=128,
    D_k=8, D_v=8, D_inner=32, eager=False, stream_chunk_group=2,
    shuffle=True, compute_dtype="float32",
    tasks={"task0": {"id": 0, "name": "metastases", "act_fn": "sigmoid",
                     "metric": "auc"}})


def card_slide(n=53, seed=2):
    """One slide of ``n`` random 32x32x3 uint8 tiles and its mask."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (1, n, 32, 32, 3), np.uint8),
            np.ones((1, n), bool))


def stream_card(argv):
    """On the card, two gloo ranks sharing cuda:0 at 1x2: one streamed
    selection of ``card_slide`` from the seed's weights; its kept indices
    and the shape of every stage."""
    out_dir, = argv
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.parallel import distributed as pdist
    from ips_tpu_torch.parallel.ips_sharded import ShardedIPSTrainer
    pdist.initialize(cpu_collectives="gloo")
    staged = []
    _record_stages(staged)
    tr = ShardedIPSTrainer(config_from_dict(dict(
        CARD_STREAM, mesh_patch=2, cpu_collectives="gloo")))
    x, m = card_slide()
    idx = tr.select_streaming(x, m, tr.new_generator(5))[2]
    torch.save({"device": str(tr.device), "idx": idx.cpu(),
                "staged": staged},
               os.path.join(out_dir, f"card{dist.get_rank()}.pt"))
    dist.destroy_process_group()

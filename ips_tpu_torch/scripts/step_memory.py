"""Time and peak device memory of one training step at a config's width.

    python -m ips_tpu_torch.scripts.step_memory --config cfg.json \
        [--grad_encode_chunk C]

One ``IPSTrainer.train_step`` on the card over a (B, M) memory batch of
random patches made from a seed (uint8 for 3-channel images, as the
camelyon_e2e path keeps them), random weights, after one warm-up step:
the step the driver runs once selection has kept M patches a row. The
``--grad_encode_chunk`` value replaces the config's (0: the whole B·M
re-encode at once). Prints one JSON line with the step's synchronised
milliseconds, the peak ``max_memory_allocated`` and the card's name and
power limit. A step that does not fit prints the same line with the
trainer's ``GradEncodeMemoryError`` text under ``out_of_memory`` (the
allocator's held and asked bytes as PyTorch's error states them) and
exits 1. Needs a CUDA card; the config is JSON or YAML.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--grad_encode_chunk", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_memory: needs a CUDA card", file=sys.stderr)
        return 1
    from ips_tpu_torch.config import load_config
    from ips_tpu_torch.train.steps import GradEncodeMemoryError, IPSTrainer
    conf = load_config(a.config)
    if a.grad_encode_chunk is not None:
        conf = conf.replace(grad_encode_chunk=a.grad_encode_chunk)
    tr = IPSTrainer(conf)
    dev = tr.device
    rng = np.random.default_rng(a.seed)
    shape = (conf.B, conf.M) + (tuple(conf.patch_size) + (conf.n_chan_in,)
                                if conf.is_image else (conf.n_chan_in,))
    if conf.is_image and conf.n_chan_in == 3:
        x = rng.integers(0, 256, shape, np.uint8)
    else:
        x = rng.random(shape, np.float32)
    x = torch.from_numpy(x).to(dev)
    mask = torch.ones((conf.B, conf.M), dtype=torch.bool, device=dev)
    labels = {}
    for t in conf.task_list:
        labels[t.name] = torch.from_numpy(
            rng.integers(0, max(conf.n_class, 2), conf.B) if t.act_fn ==
            "softmax" else (rng.random((conf.B, conf.n_class)) < 0.5
                            ).astype(np.float32)).to(dev)
    weights = torch.ones(conf.B, device=dev)
    pos = None if tr.pos_table is None else tr.pos_table[:conf.M].expand(
        conf.B, conf.M, -1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    line = {"grad_encode_chunk": conf.grad_encode_chunk,
            "batch": list(shape), "dtype": str(x.dtype), "card": card}
    times = []
    try:
        for k in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = tr.train_step(x, pos, mask, labels, weights,
                                 tr.new_generator(k), conf.lr)[0]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    except GradEncodeMemoryError as e:
        line.update(out_of_memory=str(e), steps_done=len(times),
                    peak_mib=torch.cuda.max_memory_allocated() / 2**20)
        print(json.dumps(line), flush=True)
        return 1
    line.update(loss=float(loss), warmup_ms=times[0] * 1e3,
                step_ms=times[1] * 1e3,
                peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

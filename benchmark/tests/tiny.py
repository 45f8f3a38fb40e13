"""Tiny cells for CPU tests: the cells' configurations and traffic at a
size the CPU holds, in float32, with the cells' own limits."""

from __future__ import annotations

import copy

from benchmark import core


def cell(name: str) -> core.Cell:
    c = core.find_cell(name)
    c = copy.deepcopy(c)
    conf, t = c.config, c.workload["traffic"]
    conf.update(compute_dtype="float32", input_dtype="float32", n_worker=2)
    if c.config_name == "mnist":
        conf.update(N=16, M=4, I=4, B=4, B_seq=4, steps_per_dispatch=2)
        t.update(width=200, height=200, n_noise=4)
        if "n_images" in t:
            t.update(n_images=16, workers=1)
        else:
            t.update(pool=8, batches=3, batch=4)
            c.workload.update(checked_requests=2, warmup_requests=1)
    else:
        conf.update(M=4, I=4, B=2, B_seq=1, grad_encode_chunk=2,
                    patch_size=[32, 32], patch_stride=[32, 32])
        t.update(n_slides=6, min_tiles=10, max_tiles=20, tile=[32, 32],
                 pool=8)
    return c

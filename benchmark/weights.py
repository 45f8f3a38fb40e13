"""The benchmark's seeded initializer: every leaf of a configuration's
model under its flat reference name, drawn on the device in two calls
(one normal draw for the conv kernels, one uniform draw for everything
else that is random), from a ``torch.Generator`` on that device.

Conv kernels are He-normal over fan-out, std sqrt(2 / (k*k*c_out));
dense kernels and biases uniform in +-1/sqrt(fan_in); the query tokens
uniform in +-sqrt(1/D_k); norms start at scale 1 and bias 0, running
means at 0 and variances at 1. The arrays go to the program through its
weight bridge and, unchanged, to the reference."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.ips import parameter_shapes


def draw(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = parameter_shapes(conf)
    gen = torch.Generator(device=device).manual_seed(seed)
    conv = [k for k, s in shapes.items()
            if k.endswith("/kernel") and len(s) == 4]
    uni = [k for k, s in shapes.items()
           if k.startswith("params/") and k not in conv
           and (k.endswith("/kernel") or k.endswith("/q")
                or ("head_" in k or "/w_" in k) and k.endswith("/bias"))]
    out: Dict[str, torch.Tensor] = {}

    def split(keys, flat):
        at = 0
        for k in keys:
            n = math.prod(shapes[k])
            out[k] = flat[at:at + n].view(shapes[k])
            at += n

    normal = torch.randn(sum(math.prod(shapes[k]) for k in conv),
                         generator=gen, device=device)
    split(conv, normal)
    for k in conv:
        kh, kw, _, c_out = shapes[k]
        out[k] = out[k] * math.sqrt(2.0 / (kh * kw * c_out))
    u = torch.rand(sum(math.prod(shapes[k]) for k in uni), generator=gen,
                   device=device) * 2.0 - 1.0
    split(uni, u)
    for k in uni:
        if k.endswith("/q"):
            bound = math.sqrt(1.0 / conf["D_k"])
        else:
            layer = k.rsplit("/", 1)[0]
            bound = 1.0 / math.sqrt(shapes[f"{layer}/kernel"][0])
        out[k] = out[k] * bound
    for k, s in shapes.items():
        if k in out:
            continue
        one = k.endswith("/scale") or k.endswith("/var")
        out[k] = (torch.ones if one else torch.zeros)(s, device=device)
    return {k: out[k].contiguous() for k in shapes}

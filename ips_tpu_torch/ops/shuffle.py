"""Tie-break shuffling for patch selection (counterpart of
ips_tpu/ops/shuffle.py).

Selection never moves the (B, N, ...) patch tensor: it walks a
permutation of indices. With a validity mask, real patches come first and
padded slots sink to the end, so the initial top-M buffer holds real
patches whenever n_valid >= M.
"""

from __future__ import annotations

from typing import Optional

import torch

from ips_tpu_torch.parallel.mesh import rand_rows


def make_permutation(generator: Optional[torch.Generator], B: int, N: int,
                     mask: Optional[torch.Tensor], shuffle: bool,
                     shuffle_style: str = "batch",
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Return perm (B, N) int64; row b processes patches[b, perm[b]] in order.

    Without shuffle the order is the identity, or a stable valid-first
    sort under a mask. With shuffle, 'batch' shares one permutation
    across the batch and 'instance' permutes each row; the draws come
    from ``generator`` (they cannot reproduce ``jax.random``'s stream).
    """
    if mask is not None:
        device = mask.device
    if not shuffle:
        if mask is None:
            return torch.arange(N, device=device).expand(B, N)
        return torch.argsort((~mask).to(torch.int8), dim=1, stable=True)

    if generator is None:
        raise ValueError("shuffle=True requires a torch.Generator")
    gen_device = generator.device
    if shuffle_style == "batch":
        u = torch.rand((1, N), generator=generator,
                       device=gen_device).expand(B, N)
    elif shuffle_style == "instance":
        # the global batch's draw under data parallelism (parallel/mesh.py)
        u = rand_rows((B, N), generator, gen_device)
    else:
        raise ValueError(f"unknown shuffle_style {shuffle_style!r}")
    u = u.to(device)
    if mask is not None:
        # push padded slots past every real patch whatever u in [0, 1)
        u = torch.where(mask, u, u + 2.0)
    return torch.argsort(u, dim=1)

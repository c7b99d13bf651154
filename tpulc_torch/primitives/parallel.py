"""Parallel primitives of the LZ codecs (port of
`tpulc/primitives/parallel.py:orbit_flags`; the other primitives there
serve no ported codec yet).  `orbit_flags` walks one jump table (lzss);
`orbit_flags_batched` walks a row of them at once (culzss, one row a
packet, where tpulc runs the 1-D form under `vmap`)."""

from __future__ import annotations

import torch


def orbit_flags(jump_e: torch.Tensor, n: int, t_max: int) -> torch.Tensor:
    """Membership flags of the orbit of 0 under a jump table.

    jump_e: integer [n+1] with every entry in (i, n] for i < n and
    jump_e[n] == n (absorbing end).  Returns bool[n]: True where the
    chain 0 -> jump_e[0] -> ... lands.  `t_max` bounds the orbit length
    (<= n; callers pass n / min_step).  A one-row `orbit_flags_batched`."""
    return orbit_flags_batched(jump_e[None], n, t_max)[0]


def orbit_flags_batched(jump_e: torch.Tensor, n: int,
                        t_max: int) -> torch.Tensor:
    """`orbit_flags` of every row of an integer [R, n+1] jump table ->
    bool[R, n].

    Path doubling, as tpulc: after round k the table F jumps 2^k steps
    and the positions P[:, 0:2^k] are final, so P[:, 2^k:2^(k+1)] =
    F[P[:, 0:2^k]]; log2(t_max) gathers along the last axis and one
    scatter of the landing set.  tpulc's `dynamic_update_slice` is a
    slice assignment here."""
    T = 1
    while T < t_max:
        T *= 2
    F = jump_e.to(torch.int64)
    R = F.shape[0]
    P = torch.full((R, T), n, dtype=torch.int64, device=F.device)
    P[:, 0] = 0
    step = 1
    while step < T:
        P[:, step: 2 * step] = torch.gather(F, 1, P[:, :step])
        if step * 2 < T:
            F = torch.gather(F, 1, F)
        step *= 2
    flags = torch.zeros((R, n + 1), dtype=torch.bool, device=F.device)
    flags.scatter_(1, P.clamp(max=n), True)
    return flags[:, :n]

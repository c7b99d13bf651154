"""Parallel primitives of the LZ codecs (port of
`tpulc/primitives/parallel.py:orbit_flags`; the other primitives there
serve no ported codec yet)."""

from __future__ import annotations

import torch


def orbit_flags(jump_e: torch.Tensor, n: int, t_max: int) -> torch.Tensor:
    """Membership flags of the orbit of 0 under a jump table.

    jump_e: integer [n+1] with every entry in (i, n] for i < n and
    jump_e[n] == n (absorbing end).  Returns bool[n]: True where the
    chain 0 -> jump_e[0] -> ... lands.  `t_max` bounds the orbit length
    (<= n; callers pass n / min_step).

    Path doubling, as tpulc: after round k the table F jumps 2^k steps
    and the positions P[0:2^k] are final, so P[2^k:2^(k+1)] =
    F[P[0:2^k]]; log2(t_max) gathers and one scatter of the landing set.
    tpulc's `dynamic_update_slice` is a slice assignment here."""
    T = 1
    while T < t_max:
        T *= 2
    F = jump_e.to(torch.int64)
    P = torch.full((T,), n, dtype=torch.int64, device=F.device)
    P[0] = 0
    step = 1
    while step < T:
        P[step: 2 * step] = F[P[:step]]
        if step * 2 < T:
            F = F[F]
        step *= 2
    flags = torch.zeros(n + 1, dtype=torch.bool, device=F.device)
    flags[P.clamp(max=n)] = True
    return flags[:n]

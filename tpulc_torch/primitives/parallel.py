"""Data-parallel primitives: cudpp's scan / segmented scan / compact /
reduce / sorts / merge / multisplit / listrank surface, and the orbit
walks of the LZ codecs (port of `tpulc/primitives/parallel.py`; integer
results bit-identical).

Operators are torch's elementwise callables: `torch.add`,
`torch.maximum` and `torch.minimum` map to `cumsum`, `cummax` and
`cummin`; any other associative `op(a, b)` (tpulc takes any through
`associative_scan`) runs as a log-step (Hillis-Steele) scan that calls
`op` on shifted tensors, earlier operand first.  `orbit_flags` walks one
jump table (lzss); `orbit_flags_batched` walks a row of them at once
(culzss, one row a packet, where tpulc runs the 1-D form under `vmap`).
"""

from __future__ import annotations

import torch


def _log_step(x: torch.Tensor, combine, dim: int) -> torch.Tensor:
    """Inclusive scan of x along dim: y[i] = combine(y[i - k], y[i]) for
    k = 1, 2, 4, ... (Hillis-Steele)."""
    n = x.shape[dim]
    k = 1
    while k < n:
        x = torch.cat([x.narrow(dim, 0, k),
                       combine(x.narrow(dim, 0, n - k),
                               x.narrow(dim, k, n - k))], dim)
        k *= 2
    return x


def _inclusive(x: torch.Tensor, op, dim: int) -> torch.Tensor:
    if op is torch.add:
        return torch.cumsum(x, dim, dtype=x.dtype)
    if op is torch.maximum:
        return torch.cummax(x, dim).values
    if op is torch.minimum:
        return torch.cummin(x, dim).values
    return _log_step(x, op, dim)


def _identity_for(op, dtype: torch.dtype):
    if op is torch.add:
        return 0
    if op is torch.maximum:
        return (torch.iinfo(dtype).min if not dtype.is_floating_point
                else -float("inf"))
    if op is torch.minimum:
        return (torch.iinfo(dtype).max if not dtype.is_floating_point
                else float("inf"))
    raise ValueError("unknown identity")


def _scan(x, op, exclusive: bool, reverse: bool, dim: int) -> torch.Tensor:
    if x.shape[dim] == 0:
        # n inputs give n outputs, also for an exclusive scan (tpulc's
        # `[identity]` here is its fault F10, not followed)
        if exclusive:
            _identity_for(op, x.dtype)
        return x.clone()
    if reverse:
        x = torch.flip(x, (dim,))
    out = _inclusive(x, op, dim)
    if exclusive:
        ident = _identity_for(op, x.dtype)
        head = torch.full_like(out.narrow(dim, 0, 1), ident)
        out = torch.cat([head, out.narrow(dim, 0, out.shape[dim] - 1)], dim)
    return torch.flip(out, (dim,)) if reverse else out


def scan(x: torch.Tensor, op=torch.add, exclusive: bool = False,
         reverse: bool = False) -> torch.Tensor:
    """cudppScan: inclusive/exclusive forward/backward scans along
    axis 0.  Exclusive forms take tpulc's identities (0; the dtype's
    min or -inf for max; its max or inf for min) and raise ValueError
    for any other op."""
    return _scan(x, op, exclusive, reverse, 0)


def multi_scan(x: torch.Tensor, op=torch.add, exclusive: bool = False,
               reverse: bool = False) -> torch.Tensor:
    """cudppMultiScan: independent scans over each row of a 2-D
    [rows, cols] tensor (tpulc: `scan` under `vmap`)."""
    if x.ndim != 2:
        raise ValueError("multi_scan expects a 2-D [rows, cols] array")
    return _scan(x, op, exclusive, reverse, 1)


def segmented_scan(x: torch.Tensor, flags: torch.Tensor,
                   op=torch.add) -> torch.Tensor:
    """cudppSegmentedScan: inclusive scan along axis 0 restarting where
    flags is set (the (value, flag) monoid).  Integer add is a `cumsum`
    minus each segment's base (the sum before its head, scattered at the
    segment's number and gathered back), in int64 and cast back: the
    same wrapped integers.  Any other op runs the monoid as a log-step
    scan."""
    f = flags.to(torch.bool)
    if op is torch.add and not x.dtype.is_floating_point:
        n = x.shape[0]
        head = f.clone()
        head[:1] = True
        seg = torch.cumsum(head, 0) - 1
        c = torch.cumsum(x, 0, dtype=torch.int64)
        base = torch.zeros(n + 1, dtype=torch.int64, device=x.device)
        # heads write their own segment; the rest write one spare slot
        base.scatter_(0, torch.where(head, seg, n), c - x.to(torch.int64))
        return (c - base[seg]).to(x.dtype)

    def combine(a, b):
        av, af = a.unbind(-1)
        bv, bf = b.unbind(-1)
        return torch.stack([torch.where(bf != 0, bv, op(av, bv)),
                            ((af != 0) | (bf != 0)).to(av.dtype)], -1)

    return _log_step(torch.stack([x, f.to(x.dtype)], -1), combine, 0)[..., 0]


def compact(x: torch.Tensor, mask: torch.Tensor, fill=0):
    """cudppCompact: stable-compact masked elements to the front ->
    (the array at x's length padded with `fill`, the count)."""
    n = x.shape[0]
    m = mask.to(torch.int64)
    tgt = torch.where(mask.to(torch.bool), torch.cumsum(m, 0) - m, n)
    out = torch.full((n + 1,), fill, dtype=x.dtype, device=x.device)
    out[tgt] = x
    return out[:n], m.sum()


def reduce(x: torch.Tensor, op=torch.add) -> torch.Tensor:
    """cudppReduce (add, max, min; ValueError for any other op)."""
    if op is torch.add:
        return x.sum(dtype=x.dtype)
    if op is torch.maximum:
        return x.max()
    if op is torch.minimum:
        return x.min()
    raise ValueError("unknown op")


def sort_pairs(keys: torch.Tensor, values: torch.Tensor,
               stable: bool = True):
    """cudppRadixSort/cudppMergeSort: key-value sort by keys (CUB's
    radix sort on the card)."""
    ks, order = torch.sort(keys, stable=stable)
    return ks, values[order]


def sort_strings(packed_prefix: torch.Tensor, indices: torch.Tensor):
    """cudppStringSort's role for fixed packed prefixes: sort prefix
    keys carrying string indices (ties keep index order).  uint32
    prefixes ride in int64."""
    return sort_pairs(packed_prefix, indices)


def sort_strings_full(chars: torch.Tensor,
                      starts: torch.Tensor) -> torch.Tensor:
    """Full variable-length cudppStringSort: the order of the
    0-terminated strings packed in uint8 `chars` that start at `starts`.

    Suffix ranks of the concatenation order the strings: the 0
    terminator sorts below every byte, so a comparison stops at the
    shorter string's end.  Equal strings tie-break by what follows them,
    as tpulc's do."""
    from tpulc_torch.codecs.bwt.rotsort import _scatter_perm
    from tpulc_torch.primitives.suffix import suffix_array

    sa = suffix_array(chars)
    rank = _scatter_perm(sa, torch.arange(sa.shape[0], device=sa.device))
    return torch.sort(rank[starts.to(torch.int64)], stable=True).indices


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """moderngpu Merge: merge two sorted arrays (same dtype)."""
    return torch.sort(torch.cat([a, b])).values


def multisplit(x: torch.Tensor, buckets: torch.Tensor, num_buckets: int):
    """cudppMultiSplit: stable partition by bucket id -> (reordered
    values, bucket start offsets [num_buckets]).

    The counts follow tpulc's `mode="drop"` scatter: an id in
    [-num_buckets, 0) counts in bucket num_buckets + id (jnp's negative
    indexing) and any other id outside [0, num_buckets) counts nowhere;
    the values still sort by the raw id."""
    b = buckets.to(torch.int64)
    order = torch.sort(b, stable=True).indices
    idx = torch.where(b < 0, b + num_buckets, b)
    idx = torch.where((idx >= 0) & (idx < num_buckets), idx, num_buckets)
    counts = torch.bincount(idx, minlength=num_buckets + 1)[:num_buckets]
    return x[order], torch.cumsum(counts, 0) - counts


def listrank(next_idx: torch.Tensor, head) -> torch.Tensor:
    """cudppListRank: rank of each node along a linked list, by pointer
    doubling over ceil(log2 n) rounds (at least one)."""
    n = next_idx.shape[0]
    ptr = next_idx.to(torch.int64)
    d = torch.ones(n, dtype=next_idx.dtype, device=next_idx.device)
    for _ in range(max(1, (n - 1).bit_length())):
        live = ptr != head
        ptr, d = torch.where(live, ptr[ptr], ptr), torch.where(live,
                                                               d + d[ptr], d)
    total = d[head]
    return torch.remainder(total - d, torch.clamp(total, min=1))


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

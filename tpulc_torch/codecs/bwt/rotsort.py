"""Rotation-sort BWT by prefix doubling; inverse by anchored lane walks
or pointer doubling (port of `tpulc/codecs/bwt/rotsort.py`: `last`,
`idx0`, anchors and `ok` bit-identical).

Forward — rank vectors refine by generalized prefix doubling: each
round sorts rotations by (rank[i], rank[i+k], ..., rank[i+7k]) and
extends the covered prefix k -> 8k.  `torch.sort` takes one key, so the
eight rank keys are packed several to an int64 (ranks < n need
bit_length(n-1) bits each) and sorted least-significant word first
with stable sorts — the same order as tpulc's stable 8-key `lax.sort`.
tpulc's `while_loop`/`cond` becomes a Python loop that syncs once per
round on (done, trigger).

tpulc inverts permutations and applies the last column through extra
key-value sorts because scatters and gathers are slow on the TPU
(`rotsort.py:21-39`); here they are plain scatters and gathers.
"""

from __future__ import annotations

import torch

from tpulc_torch.codecs.bwt.ibwt_kernels import anchored_walk
from tpulc_torch.primitives.scan_kernels import running_min
from tpulc_torch.utils import timing

_FAN = 8  # ranks composed per refinement round (depth 8 -> 64 -> 512)


def _stable_multikey_order(keys: list[torch.Tensor], highs: list[int]):
    """Stable lexicographic order of rows by `keys` (first key most
    significant, ties by position; key j in [0, highs[j]]) -> (order,
    diff), where diff[j] is True when sorted row j+1's keys differ from
    row j's.  As many keys as fit go into each int64 word; words past
    the first are sorted least-significant first, each stably."""
    groups, used = [[]], 0
    for key, hi in zip(keys, highs):
        bits = max(1, int(hi).bit_length())
        if used + bits > 63:
            groups.append([])
            used = 0
        groups[-1].append((key, bits))
        used += bits
    words = []
    for group in groups:
        w = torch.zeros_like(group[0][0], dtype=torch.int64)
        for key, bits in group:
            w = (w << bits) | key.to(torch.int64)
        words.append(w)
    order = None
    for w in reversed(words):
        o = torch.sort(w if order is None else w[order], stable=True).indices
        order = o if order is None else order[o]
    diff = None
    for w in words:
        s = w[order]
        d = s[1:] != s[:-1]
        diff = d if diff is None else diff | d
    return order, diff


def _zero_run_mask(data: torch.Tensor, idx: torch.Tensor, n: int):
    """bool[n]: the maximal cyclic zero run through the block boundary
    (rotations inside it are ordered by ascending position; see
    tpulc's `_zero_run_mask`)."""
    nz = data != 0
    any_nz = timing.wait(bool, nz.any())
    if not any_nz:
        return torch.zeros(n, dtype=torch.bool, device=data.device)
    first_nz = timing.wait(int, torch.argmax(nz.to(torch.int8)))
    last_nz = n - 1 - timing.wait(
        int, torch.argmax(torch.flip(nz, (0,)).to(torch.int8)))
    return (idx > last_nz) | (idx < first_nz)


def _tied_rows(diff: torch.Tensor) -> torch.Tensor:
    """Per-sorted-row 'group size > 1' flags; diff[j] marks row j+1
    starting a new group."""
    one = torch.ones(1, dtype=torch.bool, device=diff.device)
    return ~(torch.cat([one, diff]) & torch.cat([diff, one]))


def _scatter_perm(order: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out[order[i]] = values[i]."""
    out = torch.empty_like(values)
    out[order] = values
    return out


def _pair_resolve(data, rank, pf_rot, ps_rot, P: int, n: int):
    """Resolve all (i, i+P) tied pairs at once from the sign of the first
    cyclic mismatch between the block and its own P-rotation."""
    dev = data.device
    d32 = data.to(torch.int64)
    shifted = torch.roll(d32, -P)
    cmpv = torch.sign(d32 - shifted)
    cmp2 = torch.cat([cmpv, cmpv])
    idx2 = torch.arange(2 * n, device=dev)
    sent = 1 << 30
    enc = torch.where(cmp2 != 0, (idx2 << 2) | (cmp2 + 1), sent)
    fnz = running_min(enc, reverse=True)[:n]
    v = torch.where(fnz >= sent, 0, (fnz & 3) - 1)
    ok = not timing.wait(bool, (pf_rot & (v == 0)).any())
    vP = torch.roll(v, P)  # v[(x - P) mod n]
    loser = (pf_rot & (v > 0)) | (ps_rot & (vP < 0))
    return rank * 2 + loser.to(rank.dtype), ok


def _refine_ranks(data: torch.Tensor, idx: torch.Tensor, n: int):
    """Rotation ranks by generalized prefix doubling -> (rank int64[n],
    done bool); ties left in `rank` lie inside the boundary zero run and
    break by ascending position (see tpulc's `_refine_ranks`)."""
    dev = data.device
    run = _zero_run_mask(data, idx, n)

    # initial ranks from the 8-byte prefix, as one signed int64 key
    byte = data.to(torch.int64)
    key4a = ((byte << 24) | (torch.roll(byte, -1) << 16)
             | (torch.roll(byte, -2) << 8) | torch.roll(byte, -3))
    key8 = ((key4a - (1 << 31)) << 32) + torch.roll(key4a, -4)
    ks, order = torch.sort(key8, stable=True)
    diff = ks[1:] != ks[:-1]
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    rank = _scatter_perm(order, torch.cumsum(torch.cat(
        [zero, diff.to(torch.int64)]), 0))
    done = not timing.wait(bool, (_tied_rows(diff) & ~run[order]).any())

    k = 8
    t1 = torch.ones(1, dtype=torch.bool, device=dev)
    while k < n and not done:
        with timing.stage("bwt.round"):
            keys = [rank] + [torch.roll(rank, -((k * j) % n))
                             for j in range(1, _FAN)]
            order, diff = _stable_multikey_order(keys, [n - 1] * _FAN)
            newgrp = torch.cat([zero, diff.to(torch.int64)])
            tied = _tied_rows(diff) & ~run[order]
            # row-space pair shape: a group of exactly 2 rows
            new_grp = torch.cat([t1, diff])
            last_grp = torch.cat([diff, t1])
            succ_last = torch.cat([last_grp[1:], t1])
            pf_row = tied & new_grp & ~last_grp & succ_last
            ps_row = torch.cat([~t1, pf_row[:-1]])
            all_pairs = ~(tied & ~(pf_row | ps_row)).any()
            d = torch.roll(order, -1) - order
            big = 1 << 29
            dmin = torch.where(pf_row, d, big).min()
            dmax = torch.where(pf_row, d, -big).max()
            done_t = ~tied.any()
            flags = timing.wait(  # one host sync a round
                torch.Tensor.tolist, torch.stack([
                    done_t.to(torch.int64), all_pairs.to(torch.int64), dmin,
                    dmax]))
            done = bool(flags[0])
            dmin_i, dmax_i = int(flags[2]), int(flags[3])
            trigger = (not done and bool(flags[1]) and dmin_i == dmax_i
                       and 0 < dmin_i < n)
            rank = _scatter_perm(order, torch.cumsum(newgrp, 0))
            if trigger:
                pf_rot = _scatter_perm(order, pf_row)
                ps_rot = _scatter_perm(order, ps_row)
                rank2, resolved = _pair_resolve(data, rank, pf_rot, ps_rot,
                                                dmin_i, n)
                if resolved:
                    rank, done = rank2, True
        k *= _FAN
    return rank, done


def bwt_encode_anchored(data: torch.Tensor, anchor_stride: int = 1024):
    """BWT + decode-restart anchors of uint8[n] -> (last uint8[n], idx0
    int, anchors int32[R], ok bool); ok is False when rotation ranks were
    not unique (periodic input) — callers then use `bwt_decode`.

    anchors[j] = row((n - j*S) mod n), a strided read of the final
    inverse permutation (libbsc's restart-index idea, `bwt.cpp:359`)."""
    n = data.shape[0]
    S = anchor_stride
    R = -(-n // S)
    dev = data.device
    idx = torch.arange(n, device=dev)
    rank, ok = _refine_ranks(data, idx, n)
    order = torch.sort(rank, stable=True).indices
    last = torch.roll(data, 1)[order]
    idx0 = timing.wait(int, torch.argmax((order == 0).to(torch.int8)))
    rank_final = _scatter_perm(order, idx)
    j = torch.arange(R, device=dev)
    anchors = rank_final[(n - j * S) % n].to(torch.int32)
    return last, idx0, anchors, ok


def _lf_map(last: torch.Tensor) -> torch.Tensor:
    """LF map T[j] = C[L[j]] + occ(L[j], j) as int32[n] (the walk's
    table entry)."""
    n = last.shape[0]
    order = torch.sort(last.to(torch.int32), stable=True).indices
    return _scatter_perm(order, torch.arange(n, dtype=torch.int32,
                                             device=last.device))


def bwt_decode_anchored(last: torch.Tensor, anchors: torch.Tensor,
                        anchor_stride: int = 1024) -> torch.Tensor:
    """Inverse BWT via anchored lane walks: each of R lanes runs S serial
    LF steps from its anchor (anchors[0] == idx0 by construction); on
    the card one thread a lane (`ibwt_kernels.anchored_walk`)."""
    n = last.shape[0]
    return anchored_walk(_lf_map(last), last, anchors, n, anchor_stride, n)


def bwt_decode(last: torch.Tensor, idx0: int) -> torch.Tensor:
    """Inverse BWT of uint8[n] + primary index by pointer doubling (the
    metadata-free decoder for blocks whose ranks were not unique)."""
    n = last.shape[0]
    dev = last.device
    T = _lf_map(last)
    rounds = max(1, (n - 1).bit_length())
    ptr = T.clone()
    d = torch.ones(n, dtype=torch.int64, device=dev)
    for _ in range(rounds):
        live = ptr != idx0
        nptr = ptr[ptr]
        nd = d + d[ptr]
        ptr = torch.where(live, nptr, ptr)
        d = torch.where(live, nd, d)
    in_cycle = ptr == idx0
    # cycle length through idx0 (== n unless periodic)
    p = timing.wait(int, d[idx0])
    # out[n-1-k] = L[T^k(idx0)], node i visited at k = (p - d[i]) mod p
    slot = torch.where(in_cycle, (p - d) % p, n)
    order = torch.sort(slot).indices
    cyc = last[order]
    j = torch.arange(n, device=dev)
    return cyc[(n - 1 - j) % p]

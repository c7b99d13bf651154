"""Dynamic-length BWT at a fixed capacity (port of
`tpulc/codecs/bwt/masked.py`; `last`, `idx0`, anchors, `ok`, ranks and
the RLE2 symbols, their count and histogram bit-identical).

The bsc codec transforms the LZP output, whose length n is data
dependent, in a zero-padded buffer of capacity `cap`.  Padding rows get
unique ranks after every real rank and never move, so the real
rotations fill the first n sorted rows.

tpulc reads the cyclic neighbour ``rank[(i + k) mod n]`` through a
doubled buffer and a `dynamic_slice` at a traced offset, because random
access is the TPU's expensive primitive (`masked.py:9-16`); here it is
a gather at ``(i + k) mod n``.  The keys of padding rows differ from
tpulc's garbage there, but a padding row's own rank is unique, so they
never decide an order or a group.  The anchored inverse is the walk
that `rotsort.bwt_decode_anchored` runs too (`ibwt_kernels`), over this
module's `_lf_map`.
"""

from __future__ import annotations

import torch

from tpulc_torch.codecs.bwt.ibwt_kernels import anchored_walk
from tpulc_torch.codecs.bwt.rotsort import (
    _FAN,
    _scatter_perm,
    _stable_multikey_order,
    _tied_rows,
)
from tpulc_torch.codecs.bwt.rle import ALPHABET, rle2_decode, rle2_encode
from tpulc_torch.primitives.histogram import prefix_hist
from tpulc_torch.primitives.mtf import mtf_decode, mtf_encode
from tpulc_torch.utils import timing

ANCHOR_STRIDE = 512


def _wrapped(x: torch.Tensor, idx: torch.Tensor, off: int, n: int):
    """x[(i + off) mod n] on real rows i < n, x[i] on padding rows."""
    return x[torch.where(idx < n, (idx + off) % max(n, 1), idx)]


def _zero_run_mask_masked(data, idx, n: int):
    """The boundary zero run of the valid region (cyclic through n-1 ->
    0); ties inside it are benign (see rotsort._zero_run_mask)."""
    real = idx < n
    nz = real & (data != 0)
    if not timing.wait(bool, nz.any()):
        return torch.zeros_like(real)
    first_nz = timing.wait(int, torch.argmax(nz.to(torch.int8)))
    last_nz = timing.wait(int, torch.where(nz, idx, -1).max())
    return real & ((idx > last_nz) | (idx < first_nz))


def _refine_ranks_masked(data: torch.Tensor, idx: torch.Tensor, n: int,
                         benign_ties: bool = True):
    """Rotation ranks of the n-length string at capacity cap ->
    (rank int64[cap], done bool), as tpulc's `_refine_ranks_masked`:
    fan-8 prefix doubling from the 8-byte cyclic prefix, one host sync
    a round.  With benign ties, ties inside the boundary zero run end
    the refinement (they break by position); without, ties refine until
    they resolve or k >= n (equal rotations of a periodic block)."""
    cap = data.shape[0]
    real = idx < n
    run = (_zero_run_mask_masked(data, idx, n) if benign_ties
           else torch.zeros_like(real))

    # initial ranks from the 8-byte cyclic prefix as one signed int64
    # (order-preserving for the two big-endian u32 halves); padding rows
    # sort last, in position order, and each is a group of its own
    byte = data.to(torch.int64)
    b = [byte] + [_wrapped(byte, idx, j, n) for j in range(1, 8)]
    key4a = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
    key4b = (b[4] << 24) | (b[5] << 16) | (b[6] << 8) | b[7]
    key8 = ((key4a - (1 << 31)) << 32) + key4b
    key8 = torch.where(real, key8, torch.iinfo(torch.int64).max)
    ks, order = torch.sort(key8, stable=True)
    diff = (ks[1:] != ks[:-1]) | ~real[order][1:]
    zero = torch.zeros(1, dtype=torch.int64, device=data.device)
    rank = _scatter_perm(order, torch.cumsum(
        torch.cat([zero, diff.to(torch.int64)]), 0))
    done = not timing.wait(bool, (_tied_rows(diff) & ~run[order]).any())

    k = 8
    while k < n and not done:
        with timing.stage("bwt.round"):
            keys = [rank] + [_wrapped(rank, idx, (j * k) % n, n)
                             for j in range(1, _FAN)]
            order, diff = _stable_multikey_order(keys, [cap - 1] * _FAN)
            rank = _scatter_perm(order, torch.cumsum(
                torch.cat([zero, diff.to(torch.int64)]), 0))
            done = not timing.wait(bool,
                                   (_tied_rows(diff) & ~run[order]).any())
        k *= _FAN
    return rank, done


def bwt_encode_masked(data: torch.Tensor, n: int):
    """BWT of the first n bytes of uint8[cap] in libbzip2's order ->
    (last uint8[cap] (0 past n), idx0 int), as tpulc's
    `bwt_encode_masked(..., tie_desc=True)`: ties refine without the
    benign zero-run shortcut, and rotations still equal at k >= n (a
    periodic block) sort by descending position, so `origPtr` matches
    libbzip2's on periodic blocks."""
    cap = data.shape[0]
    idx = torch.arange(cap, device=data.device)
    rank, _ = _refine_ranks_masked(data, idx, n, benign_ties=False)
    # stable sort of the reversed rows: equal ranks by descending index
    # (padding rows' ranks are unique, so their tie key never decides)
    flip = torch.flip(idx, (0,))
    order = flip[torch.sort(rank[flip], stable=True).indices]
    real = idx < n
    prev = data[torch.where(real, (idx - 1) % max(n, 1), idx)]
    last = torch.where(real, prev[order], 0).to(torch.uint8)
    idx0 = timing.wait(int, torch.argmax(((order == 0) & real).to(torch.int8)))
    return last, idx0


def bwt_encode_masked_anchored(data: torch.Tensor, n: int,
                               anchor_stride: int = ANCHOR_STRIDE):
    """Masked BWT + decode-restart anchors of the first n bytes of
    uint8[cap] -> (last uint8[cap] (0 past n), idx0 int, anchors
    int32[R], ok bool) with R = ceil(cap / stride); anchors past
    ceil(n / stride) repeat idx0."""
    cap = data.shape[0]
    S = anchor_stride
    R = -(-cap // S)
    dev = data.device
    idx = torch.arange(cap, device=dev)
    rank, ok = _refine_ranks_masked(data, idx, n)
    order = torch.sort(rank, stable=True).indices
    real = idx < n
    prev = data[torch.where(real, (idx - 1) % max(n, 1), idx)]
    last = torch.where(real, prev[order], 0).to(torch.uint8)
    idx0 = timing.wait(int, torch.argmax(((order == 0) & real).to(torch.int8)))
    rank_final = _scatter_perm(order, idx)
    j = torch.arange(R, device=dev)
    pos = (max(n, 1) - j * S) % max(n, 1)
    anchors = torch.where(j * S < n, rank_final[pos], idx0).to(torch.int32)
    return last, idx0, anchors, ok


def _lf_map(last: torch.Tensor, n: int) -> torch.Tensor:
    """LF successor map int32[cap] over the valid prefix (padding rows
    map to themselves)."""
    cap = last.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=last.device)
    real = idx < n
    sym = torch.where(real, last.to(torch.int32), 256 + idx)
    order = torch.sort(sym, stable=True).indices
    return torch.where(real, _scatter_perm(order, idx), idx)


def bwt_decode_masked_anchored(last: torch.Tensor, n: int,
                               anchors: torch.Tensor,
                               anchor_stride: int = ANCHOR_STRIDE):
    """Anchored masked inverse BWT -> uint8[cap] (valid prefix n, zeros
    past it): lane j runs S serial LF steps from anchors[j] (anchors[0]
    == idx0), and its steps are output positions n-1-j*S downwards; on
    the card one thread a lane (`ibwt_kernels.anchored_walk`)."""
    cap = last.shape[0]
    return anchored_walk(_lf_map(last, n), last, anchors, n, anchor_stride,
                         cap)


def bwt_decode_masked(last: torch.Tensor, n: int, idx0: int):
    """Inverse BWT of the first n bytes of uint8[cap] -> uint8[cap] by
    pointer doubling (the metadata-free fallback for blocks whose
    rotation ranks were not unique)."""
    cap = last.shape[0]
    dev = last.device
    idx = torch.arange(cap, device=dev)
    real = idx < n
    ptr = _lf_map(last, n)
    d = torch.ones(cap, dtype=torch.int64, device=dev)
    for _ in range(max(1, (cap - 1).bit_length())):
        live = (ptr != idx0) & real
        nptr, nd = ptr[ptr], d + d[ptr]
        ptr = torch.where(live, nptr, ptr)
        d = torch.where(live, nd, d)
    in_cycle = (ptr == idx0) & real
    p = max(timing.wait(int, d[idx0]), 1)
    slot = torch.where(in_cycle, (p - d) % p, cap)
    cyc = torch.zeros(cap + 1, dtype=torch.uint8, device=dev)
    cyc[slot] = last
    return cyc[(n - 1 - idx) % p]


def forward_ranks_anchored(block: torch.Tensor, n: int,
                           anchor_stride: int = ANCHOR_STRIDE):
    """BWT + MTF without RLE2, for the group-rank coder -> (ranks
    int32[cap], 0 past n; idx0; anchors; ok).  MTF runs K1 and K2."""
    cap = block.shape[0]
    last, idx0, anchors, ok = bwt_encode_masked_anchored(
        block, n, anchor_stride)
    ranks = mtf_encode(last).to(torch.int32)
    idx = torch.arange(cap, device=block.device)
    return torch.where(idx < n, ranks, 0), idx0, anchors, ok


def forward_masked_anchored(block: torch.Tensor, n: int,
                            anchor_stride: int = ANCHOR_STRIDE):
    """BWT + MTF + RLE2 for coder 1 -> (syms int32[cap], m int64 0-dim
    (the RLE2 symbols of the first n bytes), idx0, anchors, ok).  Pads
    are MTF rank 255, each one literal symbol, so m = m_all - (cap - n).
    MTF runs K1, the start tables and K2."""
    cap = block.shape[0]
    with timing.stage("bsc.bwt"):
        last, idx0, anchors, ok = bwt_encode_masked_anchored(
            block, n, anchor_stride)
    with timing.stage("bsc.mtf"):
        idx = torch.arange(cap, device=block.device)
        ranks = torch.where(idx < n, mtf_encode(last), 255).to(torch.uint8)
    with timing.stage("bsc.rle"):
        syms, m_all = rle2_encode(ranks)
    return syms, m_all - (cap - n), idx0, anchors, ok


def forward_masked(block: torch.Tensor, n: int):
    """tpulc's unanchored `forward_masked` -> (syms, m, idx0, hist
    int64[ALPHABET] of syms[:m]): tpulc's unanchored BWT refines and
    orders the rows as the anchored one does."""
    syms, m, idx0, _, _ = forward_masked_anchored(block, n)
    return syms, m, idx0, prefix_hist(syms, m, ALPHABET)


def inverse_masked(syms: torch.Tensor, m: int, n: int, idx0: int):
    """RLE2 -> MTF (K4) -> BWT inverse by pointer doubling -> uint8[cap]."""
    ranks, _ = rle2_decode(syms, m)
    return bwt_decode_masked(mtf_decode(ranks), n, idx0)


def inverse_masked_anchored(syms: torch.Tensor, m: int, n: int,
                            anchors: torch.Tensor,
                            anchor_stride: int = ANCHOR_STRIDE):
    """Anchored inverse pipeline: RLE2 -> MTF (K4) -> anchored IBWT."""
    with timing.stage("bsc.rle.decode"):
        ranks, _ = rle2_decode(syms, m)
    with timing.stage("bsc.mtf.decode"):
        last = mtf_decode(ranks)
    with timing.stage("bsc.ibwt"):
        return bwt_decode_masked_anchored(last, n, anchors, anchor_stride)


def inverse_ranks_anchored(ranks: torch.Tensor, n: int,
                           anchors: torch.Tensor,
                           anchor_stride: int = ANCHOR_STRIDE):
    """Anchored inverse from the MTF rank stream (MTF decode runs K4)."""
    last = mtf_decode(ranks.to(torch.uint8))
    return bwt_decode_masked_anchored(last, n, anchors, anchor_stride)


def inverse_ranks(ranks: torch.Tensor, n: int, idx0: int):
    """Anchor-less inverse from the MTF rank stream (pointer doubling)."""
    return bwt_decode_masked(mtf_decode(ranks.to(torch.uint8)), n, idx0)

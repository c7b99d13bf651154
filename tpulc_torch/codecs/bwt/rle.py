"""bzip2-style zero-run coding (RUNA/RUNB), port of
`tpulc/codecs/bwt/rle.py` (bit-identical symbols and counts).

bzip2's `generateMTFValues` (`cuda-bzip2-ipdpsw/compress.c:123-240`)
replaces runs of MTF-rank zeros with bijective base-2 digits.  Both
directions are scans:

encode: zero-run starts/lengths via max/min scans; a run of L zeros
  emits k = floor(log2(L+1)) digits, digit i = bit i of (L+1) (LSB
  first, 0->RUNA, 1->RUNB); each token's record is scattered to its
  output offset and every output slot reads the latest record at or
  before it (a running max of token slots plus one gather).

decode: run-group membership via a max scan; each group's zero count
  is a per-group sum of (digit+1)<<i (`index_add_` over group ids, in
  place of tpulc's reverse segmented scan); literals scatter at cumsum
  offsets into a zero-initialised output.

The running max and min scans are `primitives/scan_kernels.py`'s: a hand
kernel on the card, torch's cummax / cummin on the CPU.

Alphabet: 0 = RUNA, 1 = RUNB, nonzero MTF rank r -> symbol r+1
(2..256); 257-symbol Huffman alphabet, no EOB.
"""

from __future__ import annotations

import torch

from tpulc_torch.primitives.scan_kernels import running_max, running_min

RUNA = 0
RUNB = 1
ALPHABET = 257  # 2 run symbols + ranks 1..255 shifted to 2..256


def rle2_encode(ranks: torch.Tensor):
    """uint8[n] MTF ranks -> (symbols int32[n], m int64 0-dim count).

    Output never exceeds input length (k digits <= L zeros; literals 1:1).
    """
    n = ranks.shape[0]
    dev = ranks.device
    r = ranks.to(torch.int64)
    i = torch.arange(n, device=dev)
    z = r == 0
    prev_nz = running_max(torch.where(z, -1, i))
    is_run_start = z & (i == prev_nz + 1)
    next_nz = running_min(torch.where(z, n, i), reverse=True)
    L = torch.where(is_run_start, next_nz - i, 0)
    M = L + 1
    # k = floor(log2(M)), exact from the binary exponent (M >= 1)
    k = torch.where(is_run_start, torch.frexp(M.to(torch.float64))[1] - 1, 0)
    emit = torch.where(z, k, 1)
    off = torch.cumsum(emit, 0) - emit
    m = off[-1] + emit[-1]

    # one record per token (literal or run start), at its output offset
    tok = ~z | is_run_start
    RUNBIT = 1 << 30
    rec = torch.where(z, M | RUNBIT, r + 1)
    rec_at = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    rec_at[torch.where(tok, off, n)] = rec
    rec_at = rec_at[:n]
    owner = running_max(torch.where(rec_at > 0, i, -1)).clamp(min=0)
    o_rec = rec_at[owner]
    is_run_slot = (o_rec & RUNBIT) != 0
    digit = (o_rec >> (i - owner).clamp(0, 29)) & 1
    out = torch.where(is_run_slot, digit, o_rec)
    out = torch.where(i < m, out, 0)
    return out.to(torch.int32), m


def rle2_decode(symbols: torch.Tensor, m):
    """int32[cap] symbols (valid prefix m) -> (ranks uint8[cap], n int64
    0-dim).

    cap bounds the decoded length (a valid stream never expands past the
    encoder's input length, which the container records).
    """
    cap = symbols.shape[0]
    dev = symbols.device
    i = torch.arange(cap, device=dev)
    valid = i < m
    s = torch.where(valid, symbols.to(torch.int64), 2)
    isrun = valid & (s <= 1)
    prev_lit = running_max(torch.where(isrun, -1, i))
    pos_in_group = i - (prev_lit + 1)
    contrib = torch.where(isrun, (s + 1) << pos_in_group.clamp(0, 30), 0)
    is_gstart = isrun & (pos_in_group == 0)
    gid = torch.cumsum(is_gstart.to(torch.int64), 0) - 1
    gsum = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    gsum.index_add_(0, torch.where(isrun, gid, cap), contrib)
    # the reference sums in int32; wrap alike
    L_at_start = gsum[gid.clamp(min=0)].to(torch.int32).to(torch.int64)
    out_len = torch.where(valid & is_gstart, L_at_start,
                          torch.where(valid & ~isrun, 1, 0))
    off = torch.cumsum(out_len, 0) - out_len
    n = off[-1] + out_len[-1]
    lit = valid & (s >= 2)
    out = torch.zeros(cap + 1, dtype=torch.uint8, device=dev)
    tgt = torch.where(lit & (off >= 0) & (off < cap), off, cap)
    out[tgt] = (s - 1).to(torch.uint8)
    return out[:cap], n

"""Group-rank adaptive binary rANS coder, the bsc `-e2` coder (port of
`tpulc/codecs/bsclike/grc.py`; words, counts, states and inits
bit-identical).

The MTF rank stream is coded as (rank, run-length) groups (libbsc's
QLFC decomposition, `qlfc.cpp:448-752`): rank == 1 test, exponent
unary, tree-path mantissa; run == 1 test, exponent, tree-path mantissa.
Each binary event mixes a fine adaptive counter, a family-level coarse
counter and a block-static init, ``(19 * fine + 7 * coarse + 6 * init)
>> 5``.  Lanes cut the stream every GCHUNK symbols.

Encode: `grc_lane_bits` (a pre-pass that sizes the grid) ->
`_binarize` (the event grid, time-major [W, L]) -> `_stats_quant` (the
wired inits) -> K5 `grc_walk_probs` (the forward model walk) ->
`grc_reverse_rans` (the reverse-rANS emission, a CUDA kernel on the
card, one thread a lane; tpulc leaves this stage to XLA).  Decode: K6
`grc_decode_walk`, the per-lane FSM with the same model arithmetic.
The kernels' wrappers and plain versions are in `grc_kernels.py`.

tpulc builds the grid lane-major and transposes it for its walk kernel
(`grc_pallas.py:213`); here `_binarize` writes it time-major directly.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulc_torch.primitives.scan_kernels import running_max, running_min

GCHUNK = 1024
PROB_BITS = 12
SCALE = 1 << PROB_BITS
RANS_L = 1 << 16
RATE_F = 4             # fine counter shift
RATE_C = 5             # coarse counter shift
MAX_EK = 10            # run exponent cap (k <= GCHUNK = 2^10)

B_L0 = 0
B_RT = 1
B_RE = B_RT + 256
B_RM = B_RE + 28
B_UT = B_RM + 7 * 64
B_UE = B_UT + 128
B_UM = B_UE + 40
NM = B_UM + MAX_EK * 32            # 1221
NFAM = 7
_FAM_BASES = (B_L0, B_RT, B_RE, B_RM, B_UT, B_UE, B_UM, NM)

# events per group bound: L0 + RT + 6 RE + 7 RM + UT + 9 UE + 10 UM
MAX_GROUP_BITS = 35

M32 = 0xFFFFFFFF


def fam_of_model() -> np.ndarray:
    f = np.zeros(NM, np.int32)
    for i in range(NFAM):
        f[_FAM_BASES[i]: _FAM_BASES[i + 1]] = i
    return f


def bucket_bits(maxbits: int, lo: int = 256) -> int:
    """Grid width bucket: smallest {1, 1.5}x2^k multiple of `lo` that
    covers maxbits (copy of `rans_adaptive.bucket_bits`; W decides
    which events `_stats_quant` samples, so it is part of the wire)."""
    b = lo
    while b < maxbits:
        b *= 2
    three_q = (b // 2) * 3 // 2
    if b > lo and three_q >= maxbits:
        return three_q
    return b


def _bitlen(v: torch.Tensor) -> torch.Tensor:
    """bit_length of max(v, 1) (exact through float64 for v < 2^53)."""
    return torch.frexp(v.clamp(min=1).to(torch.float64))[1].to(v.dtype)


def _ctx_regs(prev_r, prev2_r, prev_k, prev2_k, prev_e):
    q1 = prev_r.clamp(max=3)
    q2 = prev2_r.clamp(max=3)
    cR4 = q1 * 4 + q2
    cRun = (prev_k < 3).to(prev_r.dtype) * 2 + (prev2_k < 3).to(prev_r.dtype)
    hE = prev_e.clamp(max=3)
    cR4c = (q1 * 2 + (prev2_r > 0).to(prev_r.dtype)).clamp(max=3)
    cR0 = ((prev_r == 1).to(prev_r.dtype) * 4
           + (prev2_r == 1).to(prev_r.dtype) * 2
           + (prev_r > 4).to(prev_r.dtype))
    return cR4, cRun, hE, cR4c, cR0


def _rq_of(r):
    return (r - 1).clamp(0, 2) + (r == 0).to(r.dtype)


def _shift(x: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    """out[i] = x[i - s], `fill` for i < s."""
    out = torch.full_like(x, fill)
    if x.shape[0] > s:
        out[s:] = x[:-s]
    return out


def _group_shapes(r, k):
    """Per-group event counts of the rank and run halves."""
    E = torch.where(r > 1, _bitlen(r) - 1, 0)
    nRE = torch.where(r > 1, (E - 1) + (E < 7).to(r.dtype), 0)
    Ek = torch.where(k > 1, _bitlen(k) - 1, 0)
    nUE = torch.where(k > 1, (Ek - 1) + (Ek < MAX_EK).to(r.dtype), 0)
    return E, nRE, Ek, nUE


def grc_lane_bits(ranks: torch.Tensor, m: int, chunk: int = GCHUNK):
    """(event count per lane int64[L], group-start count int) — the
    host sizes the encode grid W from this pre-pass."""
    cap = ranks.shape[0]
    L = cap // chunk
    dev = ranks.device
    pos = torch.arange(cap, device=dev)
    valid = pos < m
    rk = torch.where(valid, ranks.to(torch.int64), 0)
    ilp = pos % chunk
    is_start = ((rk != 0) | (ilp == 0)) & valid
    lane_end = (pos // chunk + 1) * chunk
    nxt_start = running_min(torch.where(is_start, pos, cap + 1),
                            reverse=True)
    nxt_after = torch.cat([nxt_start[1:],
                           torch.full((1,), cap + 1, device=dev)])
    k = (torch.minimum(nxt_after, lane_end).clamp(max=m) - pos).clamp(
        1, chunk)
    E, nRE, Ek, nUE = _group_shapes(rk, k)
    ev = (((ilp == 0) & is_start).to(torch.int64)
          + (is_start & (rk > 0)).to(torch.int64) * (1 + nRE + E)
          + is_start.to(torch.int64) * (1 + nUE + Ek))
    ev = torch.where(is_start, ev, 0)
    return ev.reshape(L, chunk).sum(dim=1), int(is_start.sum())


def _binarize(ranks: torch.Tensor, m: int, W: int, chunk: int = GCHUNK):
    """ranks int32[cap] -> (event grid gmb int32[W, L], time-major, rec
    = (model+1)*2 + bit, 0 = empty; lane_bits int64[L]).

    Group starts are compacted first, so the 35 event scatter rounds
    and the prev/prev2 context reads run over the starts only (tpulc
    pads them to a static bucket `bs`; here the compact array has the
    exact length)."""
    cap = ranks.shape[0]
    L = cap // chunk
    dev = ranks.device
    pos = torch.arange(cap, device=dev)
    valid = pos < m
    rk_full = torch.where(valid, ranks.to(torch.int64), 0)
    is_start = ((rk_full != 0) | (pos % chunk == 0)) & valid
    spos = torch.nonzero(is_start).squeeze(1)
    r = rk_full[spos]
    lane = spos // chunk
    ilp = spos % chunk
    lane_end = (lane + 1) * chunk
    nxt = torch.cat([spos[1:], torch.full((1,), cap + 1, device=dev)])
    k = (torch.minimum(nxt, lane_end).clamp(max=m) - spos).clamp(1, chunk)

    same1 = _shift(lane, 1, -1) == lane
    same2 = _shift(lane, 2, -1) == lane
    prev_r = torch.where(same1, _shift(r, 1, 0), 0)
    prev_k = torch.where(same1, _shift(k, 1, 1), 1)
    prev2_r = torch.where(same2, _shift(r, 2, 0), 0)
    prev2_k = torch.where(same2, _shift(k, 2, 1), 1)
    prev_e = torch.where(prev_r > 0, _bitlen(prev_r) - 1, 0)
    cR4, cRun, hE, cR4c, cR0 = _ctx_regs(prev_r, prev2_r, prev_k, prev2_k,
                                         prev_e)
    rq = _rq_of(r)
    E, nRE, Ek, nUE = _group_shapes(r, k)
    has_l0 = ilp == 0
    has_rank = r > 0
    ev = (has_l0.to(torch.int64) + has_rank.to(torch.int64) * (1 + nRE + E)
          + 1 + nUE + Ek)
    # per-lane exclusive offsets: a cumsum minus its value at each
    # lane's first start
    excl = torch.cumsum(ev, 0) - ev
    idx = torch.arange(spos.shape[0], device=dev)
    first = running_max(torch.where(same1, 0, idx))
    off = excl - excl[first]
    lane_bits = torch.zeros(L, dtype=torch.int64, device=dev).index_add_(
        0, lane, ev)
    if L and int(lane_bits.max()) > W:
        raise ValueError(f"grid width {W} below the deepest lane")

    # one extra row W takes every masked event and is sliced off
    gmb = torch.zeros((W + 1) * L, dtype=torch.int32, device=dev)
    d = torch.zeros_like(r)

    def scat(mask, model, bit):
        rec = ((model + 1) * 2 + bit).to(torch.int32)
        tgt = torch.where(mask, off + d, W) * L + lane
        gmb[tgt] = torch.where(mask, rec, 0)
        return d + mask.to(torch.int64)

    d = scat(has_l0, torch.zeros_like(r), (r == 0).to(torch.int64))
    d = scat(has_rank, B_RT + cR4 * 16 + cRun * 4 + hE,
             (r == 1).to(torch.int64))
    for lvl in range(1, 7):
        d = scat(has_rank & (nRE >= lvl), B_RE + (lvl - 1) * 4 + cR4c,
                 (E > lvl).to(torch.int64))
    ee = E.clamp(min=1)
    for t in range(7):
        path = (r >> (E - t).clamp(min=0)).clamp(max=63)
        bit = (r >> (E - 1 - t).clamp(min=0)) & 1
        d = scat(has_rank & (E > t), B_RM + (ee - 1) * 64 + path, bit)
    d = scat(torch.ones_like(has_l0), B_UT + rq * 32 + cRun * 8 + cR0,
             (k == 1).to(torch.int64))
    for lvl in range(1, MAX_EK):
        d = scat(nUE >= lvl, B_UE + (lvl - 1) * 4 + rq,
                 (Ek > lvl).to(torch.int64))
    eek = Ek.clamp(min=1)
    for t in range(MAX_EK):
        path = (k >> (Ek - t).clamp(min=0)).clamp(max=31)
        bit = (k >> (Ek - 1 - t).clamp(min=0)) & 1
        d = scat(Ek > t, B_UM + (eek - 1) * 32 + path, bit)
    return gmb.reshape(W + 1, L)[:W], lane_bits


def _stats_quant(gmb: torch.Tensor):
    """Block stats + integer init quantisation from the time-major
    event grid -> (init int32[NM], cinit int32[NFAM], tot int64[NM]).

    As tpulc's, the counts come from every 4th event of the ROW-MAJOR
    [L, W] grid (`grc.py:336`); W is a multiple of 4 on the codec's
    path, where that is the time rows t % 4 == 0.  The quantisation is
    an IEEE float32 divide, then * 4096, then truncation."""
    W, L = gmb.shape
    flat = gmb[::4].reshape(-1) if W % 4 == 0 else gmb.T.reshape(-1)[::4]
    hist = torch.bincount(flat.clamp(max=2 * NM + 1).to(torch.int64),
                          minlength=2 * NM + 2)
    ones = hist[3::2]
    tot = hist[2::2] + ones
    bases = torch.tensor(_FAM_BASES, device=gmb.device)
    zero = torch.zeros(1, dtype=torch.int64, device=gmb.device)
    segc = torch.cat([zero, torch.cumsum(tot, 0)])[bases]
    segoc = torch.cat([zero, torch.cumsum(ones, 0)])[bases]
    ctot = segc[1:] - segc[:-1]
    cones = segoc[1:] - segoc[:-1]

    def quant(o, t):
        q = o.to(torch.float32) / t.clamp(min=1).to(torch.float32)
        p = torch.where(t > 0, (q * SCALE).to(torch.int32), SCALE // 2)
        return p.clamp(8, SCALE - 8)

    return quant(ones, tot), quant(cones, ctot), tot


def quantize_inits(ones: np.ndarray, tot: np.ndarray) -> np.ndarray:
    p = np.where(tot > 0, ones / np.maximum(tot, 1), 0.5)
    return np.clip((p * SCALE).astype(np.int64), 8, SCALE - 8).astype(
        np.uint16)


def pack_inits(inits: np.ndarray, tot: np.ndarray) -> bytes:
    """Sparse init table: bitmap of used models + u16 per used entry
    (unused ones decode to the 2048 midpoint on both sides)."""
    used = tot > 0
    bits = np.zeros(-(-NM // 8) * 8, np.uint8)
    bits[:NM] = used
    return (np.packbits(bits).tobytes()
            + inits[used].astype("<u2").tobytes())


def unpack_inits(buf: bytes, off: int):
    nb = -(-NM // 8)
    used = np.unpackbits(
        np.frombuffer(buf[off: off + nb], np.uint8))[:NM].astype(bool)
    off += nb
    nu = int(used.sum())
    vals = np.frombuffer(buf[off: off + 2 * nu], "<u2")
    off += 2 * nu
    inits = np.full(NM, SCALE // 2, np.uint16)
    inits[used] = vals
    return inits, off


def grc_encode(ranks: torch.Tensor, m: int, W: int, chunk: int = GCHUNK):
    """binarize -> block stats -> init quantisation -> K5 forward model
    walk -> reverse-rANS emission -> (words int32[L, W+2], counts int64[L],
    states int64[L], inits int32[NM], cinits int32[NFAM], tot
    int64[NM]); the values of tpulc's `grc_encode`."""
    from tpulc_torch.codecs.bsclike.grc_kernels import (
        grc_reverse_rans,
        grc_walk_probs,
    )

    gmb, lane_bits = _binarize(ranks, m, W, chunk)
    init, cinit, tot = _stats_quant(gmb)
    nsteps = int(lane_bits.max()) if lane_bits.numel() else 0
    probs = grc_walk_probs(gmb, init.contiguous(), cinit.contiguous(),
                           nsteps)
    words, counts, states = grc_reverse_rans(gmb, probs, nsteps)
    return words, counts, states, init, cinit, tot


def grc_decode(words: torch.Tensor, states: torch.Tensor, m: int,
               inits: torch.Tensor, cinits: torch.Tensor, nsteps: int,
               cap: int, chunk: int = GCHUNK) -> torch.Tensor:
    """K6 decode -> ranks int32[cap].  `words` [L, Wc] and `states` [L]
    hold uint16 / uint32 values in any integer dtype (L = cap // chunk);
    they are narrowed to the kernel's int16 / int32 bit patterns."""
    from tpulc_torch.codecs.bsclike.grc_kernels import grc_decode_walk

    w16 = words.to(torch.int32)
    w16 = torch.where(w16 >= 1 << 15, w16 - (1 << 16), w16).to(torch.int16)
    s64 = states.to(torch.int64) & M32
    s32 = torch.where(s64 >= 1 << 31, s64 - (1 << 32), s64).to(torch.int32)
    out = grc_decode_walk(w16.contiguous(), s32.contiguous(),
                          inits.to(torch.int32).contiguous(),
                          cinits.to(torch.int32).contiguous(), m, nsteps,
                          chunk)
    return out.reshape(cap)

"""Adaptive binary rANS coder, bsc's `-e2` on the ST sorters (port of
`tpulc/codecs/bsclike/rans_adaptive.py`; statistics, initial
probabilities, words, counts, states and symbols bit-identical).

Each RLE2 symbol s (alphabet 0..256) becomes up to 16 binary events,
QLFC's exponent/mantissa binarization:

    E0   bit (s == 0)            model: cls(prev) x cls4(prev2)  [32]
    E1   bit (s == 1)   if s>0   model: 32 + cls(prev)           [8]
    EXP  continuation   if s>1   model: 40 + lvl*4 + cls4(prev)  [28]
         bits of E = bit_length(s-1): lvl<E-1 -> 1, stop 0 at
         lvl=E-1 (omitted when lvl would be 7: E=8 is implied)
    MANT bits of s-1 below the top bit (MSB first)
                                 model: 68 + (E-2)*7 + pos       [49]

117 models, each a 12-bit probability of bit 1 that adapts after every
event it codes: p += ((bit << 12) - p) >> 5, clipped to [8, 4088].
The symbol stream is cut into lanes of ACHUNK = 1024 symbols; every
lane restarts its models from the block's initial probabilities (one
u16 a model on the wire, from the block's bit rates) and codes its
events with its own 32-bit rANS state, so all lanes run side by side.

Encode: `abc_stats` (the block's model bit counts, each lane's bit
count and entering context class), `quantize_inits` (host numpy,
copied), then `abc_encode`: the binarization scatters each lane's
events, one byte (model + 1) * 2 + bit, into a step-major event grid
uint8[W, lanes] (tpulc's [lanes, W] int32 grid, transposed so that a
warp's lanes read neighbouring bytes at a step), and the encode walk
(`abc_kernels.abc_encode_walk`: the model pass, then the reverse rANS
pass) codes it.  Decode: `abc_decode` is the decode walk
(`abc_kernels.abc_decode_walk`), one bit a step per lane, which
re-derives each bit's model from the symbols it has rebuilt.

tpulc selects a model's probability with one-hot sums over [lanes,
117], a TPU workaround for scatters; here the state is read and
written with `gather` / `scatter_` (plain versions) or held in shared
memory (the kernels).
"""

from __future__ import annotations

import numpy as np
import torch

from tpulc_torch.codecs.bsclike.abc_kernels import (
    NMODELS,
    abc_decode_walk,
    abc_encode_walk,
)
from tpulc_torch.codecs.bsclike.rans import _lane_counts, ctx_class

ACHUNK = 1024          # symbols per lane
PROB_BITS_A = 12
SCALE_A = 1 << PROB_BITS_A
MAX_SYM_BITS = 16      # 2 + 7 exp + 7 mantissa

NM_E0, NM_E1, NM_EXP, NM_MANT = 32, 8, 28, 49
_M_E1 = NM_E0
_M_EXP = NM_E0 + NM_E1
_M_MANT = NM_E0 + NM_E1 + NM_EXP


def _cls(s: torch.Tensor) -> torch.Tensor:
    """The rank class of each symbol (rans.py's buckets), int64."""
    return ctx_class(s).to(torch.int64)


def _bitlen(v: torch.Tensor) -> torch.Tensor:
    """bit_length of int64 v in [1, 2^31)."""
    return torch.frexp(v.to(torch.float64))[1].to(torch.int64)


def _classes(syms2: torch.Tensor):
    """[B, cap] symbols -> (c1 full class of prev, c2 capped class of
    prev2) int64, contexts flowing across lanes within a block only."""
    z1 = torch.zeros((syms2.shape[0], 1), dtype=syms2.dtype,
                     device=syms2.device)
    prev = torch.cat([z1, syms2[:, :-1]], dim=1)
    prev2 = torch.cat([z1, z1, syms2[:, :-2]], dim=1)
    return _cls(prev), _cls(prev2).clamp(max=3)


class _Binarized:
    """A symbol array's binarization, one slot q in [0, 16) at a time:
    `slot(q)` -> (model, bit, valid) of s's shape (tpulc's
    `_slot_tables`, without stacking the 16 slots)."""

    def __init__(self, s: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor):
        self.s, self.c1, self.c2 = s, c1, c2
        self.v1 = (s - 1).clamp(min=1)
        self.E = _bitlen(self.v1)
        self.nexp = self.E.clamp(max=7)
        self.nbits = torch.where(
            s == 0, 1, torch.where(s == 1, 2, 2 + self.nexp + self.E - 1))

    def slot(self, q: int):
        s, c1, E, nexp = self.s, self.c1, self.E, self.nexp
        if q == 0:
            return c1 * 4 + self.c2, (s == 0).to(torch.int64), \
                torch.ones_like(s, dtype=torch.bool)
        if q == 1:
            return _M_E1 + c1, (s == 1).to(torch.int64), s > 0
        lvl = q - 2
        in_exp = (s > 1) & (lvl < nexp)
        mpos = q - 2 - nexp  # mantissa position when >= 0
        in_mant = (s > 1) & (mpos >= 0) & (mpos <= E - 2)
        m_exp = _M_EXP + min(lvl, 6) * 4 + c1.clamp(max=3)
        b_exp = (lvl < E - 1).to(torch.int64)
        m_mant = _M_MANT + (E - 2) * 7 + mpos.clamp(min=0)
        b_mant = (self.v1 >> (E - 2 - mpos).clamp(0, 31)) & 1
        model = torch.where(in_exp, m_exp, torch.where(in_mant, m_mant, 0))
        return model, torch.where(in_exp, b_exp, b_mant), in_exp | in_mant


def _binarized(syms2: torch.Tensor, ms):
    """[B, cap] symbols and their valid lengths -> (_Binarized, valid
    bool[B, cap], bits of each symbol int64[B, cap], 0 past ms)."""
    B, cap = syms2.shape
    s = syms2.to(torch.int64)
    c1, c2 = _classes(s)
    ms_t = torch.as_tensor(ms, dtype=torch.int64, device=s.device)
    valid = torch.arange(cap, device=s.device)[None, :] < ms_t.reshape(B, 1)
    bz = _Binarized(s, c1, c2)
    return bz, valid, torch.where(valid, bz.nbits, 0)


def abc_stats(syms2: torch.Tensor, ms, chunk: int = ACHUNK):
    """Statistics before the encode: syms2 int[B, cap], ms the B valid
    lengths -> (ones int64[B, NMODELS], tot int64[B, NMODELS] (each
    block's 1-bits and events a model), lane_bits int64[B*lcap] (events
    a lane), lane_cls int64[B*lcap] (c1*4 + c2 entering each lane))."""
    B, cap = syms2.shape
    dev = syms2.device
    bz, valid, nb = _binarized(syms2, ms)
    blk = torch.arange(B, device=dev)[:, None] * NMODELS
    trash = B * NMODELS
    tot = torch.zeros(trash + 1, dtype=torch.int64, device=dev)
    ones = torch.zeros(trash + 1, dtype=torch.int64, device=dev)
    for q in range(MAX_SYM_BITS):
        model, bit, vq = bz.slot(q)
        key = torch.where(vq & valid, blk + model, trash)
        tot += torch.bincount(key.reshape(-1), minlength=trash + 1)
        ones += torch.bincount(torch.where(bit == 1, key, trash).reshape(-1),
                               minlength=trash + 1)
    lane_bits = nb.reshape(-1, chunk).sum(dim=1)
    lane_cls = (bz.c1 * 4 + bz.c2).reshape(-1, chunk)[:, 0]
    return (ones[:trash].reshape(B, NMODELS), tot[:trash].reshape(B, NMODELS),
            lane_bits, lane_cls)


def quantize_inits(ones: np.ndarray, tot: np.ndarray) -> np.ndarray:
    """[B, NMODELS] counts -> u16 initial probabilities (of bit=1)."""
    t = np.maximum(tot, 1)
    p = np.rint(ones / t * SCALE_A).astype(np.int64)
    p = np.clip(p, 16, SCALE_A - 16)
    return np.where(tot == 0, SCALE_A // 2, p).astype(np.uint16)


def event_grid(syms2: torch.Tensor, ms, W: int, chunk: int = ACHUNK):
    """The binarization of every lane -> (grid uint8[W, L] step-major:
    entry [t, l] is event t of lane l as (model + 1) * 2 + bit, 0 past
    the lane's events; lane_bits int32[L], clipped to W) with L =
    B * (cap // chunk) lanes block-major.  An event past column W-1 is
    dropped, as tpulc's scatter drops it."""
    B, cap = syms2.shape
    L = B * (cap // chunk)
    dev = syms2.device
    bz, valid, nb = _binarized(syms2, ms)
    nb = nb.reshape(L, chunk)
    offs = torch.cumsum(nb, dim=1) - nb              # within-lane offsets
    lane = torch.arange(L, device=dev)[:, None]
    trash = W * L
    grid = torch.zeros(trash + 1, dtype=torch.uint8, device=dev)
    for q in range(MAX_SYM_BITS):
        model, bit, vq = bz.slot(q)
        vq = (vq & valid).reshape(L, chunk)
        ok = vq & (offs < W)
        grid[torch.where(ok, offs * L + lane, trash)] = \
            ((model.reshape(L, chunk) + 1) * 2
             + bit.reshape(L, chunk)).to(torch.uint8)
        offs = offs + vq
    lane_bits = nb.sum(dim=1).clamp(max=W).to(torch.int32)
    return grid[:trash].reshape(W, L), lane_bits


def abc_encode(syms2: torch.Tensor, ms, inits: torch.Tensor, W: int,
               chunk: int = ACHUNK):
    """Encode [B, cap] symbol blocks -> per-lane adaptive binary rANS:
    (words int16[L, W+2] (uint16 values, the lane's first `counts`
    words in stream order), counts int64[L], states int64[L] (uint32
    values)), L = B * (cap // chunk) lanes block-major.  inits
    uint16/int[B, NMODELS]: each block's initial probabilities; W >= the
    deepest lane's bit count (`bucket_bits` of it)."""
    grid, lane_bits = event_grid(syms2, ms, W, chunk)
    return abc_encode_walk(grid, lane_bits,
                           inits.to(torch.int32).contiguous(),
                           syms2.shape[1] // chunk)


def abc_decode(words: torch.Tensor, states: torch.Tensor,
               lane_cls: torch.Tensor, ms, inits: torch.Tensor, nsteps: int,
               B: int, chunk: int = ACHUNK) -> torch.Tensor:
    """Decode L = B * lcap lanes (block-major): words int16[L, Wc] (each
    lane's words, zero past its count), states int[L] (uint32 values),
    lane_cls int[L] (c1*4 + c2 entering each lane), ms the B symbol
    counts, inits int[B, NMODELS], nsteps the deepest lane's bit count
    -> syms int32[B, lcap * chunk], 0 past each lane's symbols."""
    L = words.shape[0]
    lcap = L // B
    nsym = _lane_counts(ms, B, lcap, chunk, words.device)
    out = abc_decode_walk(words.contiguous(),
                          states.to(torch.int64).contiguous(),
                          lane_cls.to(torch.int32).contiguous(), nsym,
                          inits.to(torch.int32).contiguous(), lcap, nsteps,
                          chunk)
    return out.reshape(B, lcap * chunk)


def bucket_bits(maxbits: int, lo: int = 256) -> int:
    """Grid width bucket: smallest {1, 1.5}x2^k multiple of `lo` that
    covers maxbits (two compiles per octave instead of one, for <=33%
    grid slack instead of <=100% — every grid-wide op scales with W)."""
    b = lo
    while b < maxbits:
        b *= 2
    three_q = (b // 2) * 3 // 2
    if b > lo and three_q >= maxbits:
        return three_q
    return b

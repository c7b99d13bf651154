"""Plain decoder of the bsc container (codec 5) as coder 1 writes it on
the BWT sorter: per block, the static order-2 context rANS over
512-symbol lanes, RUNA/RUNB zero runs, move-to-front, the inverse BWT,
LZP and the record filter.  Other coders and sorters raise FormatError.

Block payload, little-endian: n, m_lzp, m, idx0, nwords (u32), flags
(u8: bit 0 LZP, bit 1 stored, bit 2 context model, bit 3 restart
anchors, bits 4-6 sorter, bit 7 filter byte), coder (u8: 1 rANS, 3
segments); [filter byte]; [anchors, ceil(log2 cap) bits each, one per
1,024 LZP bytes]; the context tables: a u32 mask of the contexts
present, then per context a 257-bit presence map (33 bytes, MSB first)
and a u16 frequency per present symbol, summing to 2^14; the lane count
(u32); each lane's first context (5 bits); per lane its u16 word count
and u32 final state; the u16 words of every lane back to back.  A
segmented block (coder 3) holds its segment count in nwords, their u32
sizes, then each segment's payload.

A symbol's context is class(previous) * 4 + min(class(the one
before), 3), with class(s) the number of the edges 1, 2, 3, 4, 6, 10,
18 that s reaches.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from portbench.reference.common import (
    FormatError,
    invert_filter,
    inverse_bwt,
    join_blocks,
    lzp_decode,
    mtf_decode,
    parse_container,
    unpack_fields,
    zero_runs_decode,
)

CODEC = 5
ALPHABET = 257
NCTX = 32
PROB_BITS = 14
LANE = 512
RANS_L = 1 << 16
M32 = 0xFFFFFFFF
_EDGES = (1, 2, 3, 4, 6, 10, 18)
_HEAD = struct.Struct("<IIIIIBB")
FLAG_LZP, FLAG_STORED, FLAG_CTX, FLAG_ANCHORS, FLAG_FILTER = 1, 2, 4, 8, 128
SORTER_BITS = 0x70


def _tables(payload: bytes, off: int):
    """The 32 context tables -> (freq int64[NCTX, ALPHABET], offset)."""
    (mask,) = struct.unpack_from("<I", payload, off)
    off += 4
    freq = np.zeros((NCTX, ALPHABET), np.int64)
    for k in range(NCTX):
        if not mask >> k & 1:
            freq[k, 0] = 1 << PROB_BITS
            continue
        present = np.unpackbits(np.frombuffer(
            payload, np.uint8, 33, off))[:ALPHABET].astype(bool)
        off += 33
        cnt = int(present.sum())
        freq[k, present] = np.frombuffer(payload, "<u2", cnt, off)
        off += 2 * cnt
    if (freq.sum(1) != 1 << PROB_BITS).any():
        raise FormatError("a context table does not sum to 2^14")
    return freq, off


def rans_decode(freq: np.ndarray, first_ctx: np.ndarray, counts: np.ndarray,
                states: np.ndarray, words: np.ndarray, m: int, dev):
    """Every lane in lockstep -> the m symbols, int64; each lane must
    read exactly its words and end in the encoder's start state."""
    L = first_ctx.shape[0]
    f = torch.from_numpy(freq).to(dev)
    cum = torch.cumsum(f, 1) - f
    slot_sym = torch.stack([torch.repeat_interleave(
        torch.arange(ALPHABET, device=dev), f[k]) for k in range(NCTX)])
    cls = torch.zeros(ALPHABET, dtype=torch.int64, device=dev)
    for e in _EDGES:
        cls += torch.arange(ALPHABET, device=dev) >= e
    w = torch.from_numpy(np.append(words, 0).astype(np.int64)).to(dev)
    cnt = torch.from_numpy(counts.astype(np.int64)).to(dev)
    base = torch.cumsum(cnt, 0) - cnt
    x = torch.from_numpy(states.astype(np.int64)).to(dev)
    k = torch.from_numpy(first_ctx.astype(np.int64)).to(dev)
    live = (m - torch.arange(L, device=dev) * LANE).clamp(0, LANE)
    read = torch.zeros(L, dtype=torch.int64, device=dev)
    out = torch.zeros((L, LANE), dtype=torch.int64, device=dev)
    for t in range(LANE):
        on = t < live
        slot = x & ((1 << PROB_BITS) - 1)
        s = slot_sym[k, slot]
        xn = f[k, s] * (x >> PROB_BITS) + slot - cum[k, s]
        low = on & (xn < RANS_L)
        word = w[torch.where(low, base + read, w.shape[0] - 1)]
        xn = torch.where(low, (xn << 16 | word) & M32, xn)
        read += low
        x = torch.where(on, xn, x)
        out[:, t] = torch.where(on, s, 0)
        k = torch.where(on, cls[s] * 4 + torch.clamp(k // 4, max=3), k)
    if not (bool((read == cnt).all()) and bool((x == RANS_L).all())):
        raise FormatError("a rANS lane does not end where its encoder began")
    return out.reshape(-1)[:m]


def decode_block(payload: bytes, block_size: int, dev,
                 nested: bool = False) -> np.ndarray:
    n, m_lzp, m, idx0, nwords, flags, coder = _HEAD.unpack_from(payload)
    off = _HEAD.size
    if flags & FLAG_STORED:
        if len(payload) != off + n:
            raise FormatError("stored block length")
        return np.frombuffer(payload, np.uint8, n, off)
    if coder == 3 and not nested:
        sizes = np.frombuffer(payload, "<u4", nwords, off).astype(np.int64)
        off += 4 * nwords
        if int(sizes.sum()) != len(payload) - off:
            raise FormatError("segment sizes")
        parts = []
        for size in sizes:
            parts.append(decode_block(payload[off: off + int(size)],
                                      block_size, dev, nested=True))
            off += int(size)
        out = np.concatenate(parts)
        if out.shape[0] != n:
            raise FormatError("segments do not fill the block")
        return out
    if coder != 1 or flags & SORTER_BITS or not flags & FLAG_CTX:
        raise FormatError(f"not a coder-1 BWT block (coder {coder}, "
                          f"flags {flags:#x})")
    filt = 0
    if flags & FLAG_FILTER:
        filt, off = payload[off], off + 1
    if flags & FLAG_ANCHORS:
        cap = -(-block_size // 1024) * 1024
        width = max(1, (cap - 1).bit_length())
        off += -(-max(1, -(-m_lzp // 1024)) * width // 8)
    freq, off = _tables(payload, off)
    (lanes,) = struct.unpack_from("<I", payload, off)
    off += 4
    if lanes != max(1, -(-m // LANE)):
        raise FormatError("lane count")
    nb = -(-lanes * 5 // 8)
    first_ctx = unpack_fields(payload[off: off + nb], 5, lanes)
    off += nb
    counts = np.frombuffer(payload, "<u2", lanes, off)
    off += 2 * lanes
    states = np.frombuffer(payload, "<u4", lanes, off)
    off += 4 * lanes
    if int(counts.sum()) != nwords or off + 2 * nwords != len(payload):
        raise FormatError("rANS word count")
    words = np.frombuffer(payload, "<u2", nwords, off)
    syms = rans_decode(freq, first_ctx, counts, states, words, m, dev)
    ranks = zero_runs_decode(syms)
    if ranks.shape[0] != m_lzp:
        raise FormatError("zero runs do not fill the LZP stage")
    stage = inverse_bwt(mtf_decode(ranks), idx0).cpu().numpy()
    if flags & FLAG_LZP:
        data = lzp_decode(stage, n)
    elif m_lzp == n:
        data = stage
    else:
        raise FormatError("stage length without LZP")
    return invert_filter(data, filt)


def decode(container: bytes, device="cpu") -> bytes:
    """A bsc container -> the bytes it holds; raises FormatError."""
    orig_len, block_size, payloads, adler = parse_container(container, CODEC)
    dev = torch.device(device)
    return join_blocks([decode_block(p, block_size, dev) for p in payloads],
                       orig_len, adler)

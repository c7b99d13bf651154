"""Plain decoder of the bz container (codec 4): per block, canonical
Huffman codes in 128-symbol chunks (one of up to six tables a chunk),
RUNA/RUNB zero runs, move-to-front, and the inverse BWT of the whole
zero-padded block.

Block payload, little-endian: n, m, idx0, total_bits (u32), mode (u8:
bit 0 restart anchors, bit 1 several tables); [K (u8)]; K tables of 257
code lengths as nibbles (129 bytes, low nibble first); the chunk count
(u32), chunk 0's bit offset (u32), 11-bit differences of the later
offsets; [3-bit table selectors]; [anchor count (u32) and 20-bit
anchors, two in five bytes]; the code words, MSB first in little-endian
u32 words.  The block's bytes were sorted at a capacity of the block
size rounded up to 256, zero-padded past n.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from portbench.reference.common import (
    FormatError,
    inverse_bwt,
    join_blocks,
    mtf_decode,
    parse_container,
    unpack_fields,
    zero_runs_decode,
)

CODEC = 4
ALPHABET = 257
MAX_LEN = 15
CHUNK = 128
_BLOCK = struct.Struct("<IIIIB")


def code_table(lengths: np.ndarray):
    """Canonical codes (shorter first, ties by symbol) of one table ->
    (symbol, length) of every 15-bit window, int64[2^15] each; a window
    that no code starts gets length 0."""
    sym = np.zeros(1 << MAX_LEN, np.int64)
    ln = np.zeros(1 << MAX_LEN, np.int64)
    code = 0
    for length in range(1, MAX_LEN + 1):
        for s in np.flatnonzero(lengths == length):
            lo = code << (MAX_LEN - length)
            hi = (code + 1) << (MAX_LEN - length)
            if hi > 1 << MAX_LEN:
                raise FormatError("code lengths over the Kraft sum")
            sym[lo:hi], ln[lo:hi] = s, length
            code += 1
        code <<= 1
    return sym, ln


def decode_block(payload: bytes, cap: int, dev) -> np.ndarray:
    n, m, idx0, total_bits, mode = _BLOCK.unpack_from(payload)
    off = _BLOCK.size
    K = 1
    if mode & 2:
        K, off = payload[off], off + 1
    if not 1 <= K <= 6 or n > cap or m > cap:
        raise FormatError("bz block header")
    tables = []
    for _ in range(K):
        nib = np.frombuffer(payload, np.uint8, 129, off)
        off += 129
        lengths = np.stack([nib & 15, nib >> 4], 1).reshape(-1)[:ALPHABET]
        tables.append(code_table(lengths))
    nchunks, off0 = struct.unpack_from("<II", payload, off)
    off += 8
    if nchunks != max(1, -(-m // CHUNK)):
        raise FormatError("bz chunk count")
    width = -(-(nchunks - 1) * 11 // 8)
    deltas = unpack_fields(payload[off: off + width], 11, nchunks - 1)
    off += width
    starts = off0 + np.concatenate([[0], np.cumsum(deltas)])
    sel = np.zeros(nchunks, np.int64)
    if mode & 2:
        width = -(-nchunks * 3 // 8)
        sel = unpack_fields(payload[off: off + width], 3, nchunks)
        off += width
        if int(sel.max()) >= K:
            raise FormatError("bz table selector")
    if mode & 1:
        (na,) = struct.unpack_from("<I", payload, off)
        off += 4 + -(-na // 2) * 5
    nwords = -(-total_bits // 32)
    if off + 4 * nwords != len(payload):
        raise FormatError("bz payload length")
    # the stream as MSB-first bytes, with room to read past its end
    words = np.frombuffer(payload, "<u4", nwords, off)
    stream = np.zeros(4 * nwords + 4, np.uint8)
    stream[: 4 * nwords] = words.astype(">u4").view(np.uint8)

    bytes_t = torch.from_numpy(stream).to(dev).to(torch.int64)
    sym_t = torch.from_numpy(np.stack([t[0] for t in tables])).to(dev)
    len_t = torch.from_numpy(np.stack([t[1] for t in tables])).to(dev)
    sel_t = torch.from_numpy(sel).to(dev)
    pos = torch.from_numpy(starts.astype(np.int64)).to(dev)
    live = (m - torch.arange(nchunks, device=dev) * CHUNK).clamp(0, CHUNK)
    syms = torch.zeros((nchunks, CHUNK), dtype=torch.int64, device=dev)
    last_byte = bytes_t.shape[0] - 3
    for t in range(CHUNK):
        on = t < live
        b = (pos >> 3).clamp(max=last_byte)
        win = (bytes_t[b] << 16 | bytes_t[b + 1] << 8 | bytes_t[b + 2]) \
            >> (9 - (pos & 7)) & ((1 << MAX_LEN) - 1)
        length = len_t[sel_t, win]
        if bool((on & (length == 0)).any()):
            raise FormatError("bz window with no code")
        syms[:, t] = torch.where(on, sym_t[sel_t, win], 0)
        pos = torch.where(on, pos + length, pos)
    ends = np.append(starts[1:], total_bits)
    if not np.array_equal(pos.cpu().numpy(), ends):
        raise FormatError("bz chunk ends")
    ranks = zero_runs_decode(syms.reshape(-1)[:m])
    if ranks.shape[0] != cap:
        raise FormatError("bz zero runs do not fill the block")
    out = inverse_bwt(mtf_decode(ranks), idx0)
    return out[:n].cpu().numpy()


def decode(container: bytes, device="cpu") -> bytes:
    """A bz container -> the bytes it holds; raises FormatError."""
    orig_len, block_size, payloads, adler = parse_container(container, CODEC)
    cap = -(-block_size // 256) * 256
    dev = torch.device(device)
    return join_blocks([decode_block(p, cap, dev) for p in payloads],
                       orig_len, adler)

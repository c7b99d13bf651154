"""Plain decoder of the huffman container (codec 1): per block, one
canonical Huffman code over the 256 byte values and a table of chunks,
each chunk decoded on its own.

Block payload, little-endian: n (u32, symbols), total_bits (u32), mode
(u8: 1 a v1 chunk table, 2 a v2 one, 0 none); 256 code lengths as
nibbles (128 bytes, low nibble first, 0 for an absent symbol); v1: the
chunk count (u32) and each chunk's first bit (u32), chunks of 256
symbols; v2: chunk_log (u8), the chunk count (u32) and each chunk's
size in bits (u16), chunks of 2^chunk_log symbols; then the code words,
MSB first in little-endian u32 words, ceil(total_bits / 32) of them.

Codes are canonical: shorter first, ties by symbol, the first code of
each length all zeros.  So the codes, left-justified to 15 bits (the
longest a nibble holds), tile [0, 2^15) from 0 in (length, symbol)
order, each over 2^(15 - length) windows, and the decode table is that
tiling.  Every chunk of every block is decoded in lockstep, a symbol a
step, on the device given; a chunk must end exactly where the next
begins, the first begin at bit 0 and the last end at total_bits.  A
block without a chunk table (mode 0, the self-synchronising layout) is
refused.  Written from the format in NumPy and plain PyTorch; nothing
here imports the program under test.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from portbench.reference.common import FormatError, join_blocks, parse_container

CODEC = 1
MAX_LEN = 15
V1_CHUNK = 256
_BLOCK = struct.Struct("<IIB")
_NIBBLES = 128


def code_table(lengths: np.ndarray):
    """Canonical code of 256 lengths -> (symbol, length) of every
    15-bit window, int64[2^15] each; a window that no code starts gets
    length 0.  Lengths over the Kraft sum are refused."""
    order = np.lexsort((np.arange(256), lengths))
    order = order[lengths[order] > 0]
    span = 1 << (MAX_LEN - lengths[order].astype(np.int64))
    if int(span.sum()) > 1 << MAX_LEN:
        raise FormatError("code lengths over the Kraft sum")
    sym = np.zeros(1 << MAX_LEN, np.int64)
    ln = np.zeros(1 << MAX_LEN, np.int64)
    used = int(span.sum())
    sym[:used] = np.repeat(order, span)
    ln[:used] = np.repeat(lengths[order], span)
    return sym, ln


def parse_block(payload: bytes, block_size: int):
    """-> (n, lengths int64[256], chunk_syms, starts int64[nchunks],
    ends int64[nchunks], stream bytes, MSB first)."""
    if len(payload) < _BLOCK.size + _NIBBLES:
        raise FormatError("huffman block header")
    n, total_bits, mode = _BLOCK.unpack_from(payload)
    off = _BLOCK.size
    nib = np.frombuffer(payload, np.uint8, _NIBBLES, off)
    off += _NIBBLES
    lengths = np.stack([nib & 15, nib >> 4], 1).reshape(-1).astype(np.int64)
    if n > block_size:
        raise FormatError("huffman block longer than the block size")
    if mode == 1:
        chunk_syms, width = V1_CHUNK, 4
        if len(payload) < off + 4:
            raise FormatError("huffman chunk table")
        (nchunks,) = struct.unpack_from("<I", payload, off)
        off += 4
    elif mode == 2:
        if len(payload) < off + 5:
            raise FormatError("huffman chunk table")
        chunk_log, nchunks = struct.unpack_from("<BI", payload, off)
        off += 5
        if chunk_log > 30:
            raise FormatError("huffman chunk_log")
        chunk_syms, width = 1 << chunk_log, 2
    else:
        raise FormatError(f"huffman block mode {mode}: no chunk table")
    if nchunks != max(1, -(-n // chunk_syms)):
        raise FormatError("huffman chunk count")
    if len(payload) < off + width * nchunks:
        raise FormatError("huffman chunk table")
    table = np.frombuffer(payload, "<u4" if width == 4 else "<u2", nchunks,
                          off).astype(np.int64)
    off += width * nchunks
    if width == 4:
        starts = table
        ends = np.append(table[1:], total_bits)
    else:
        ends = np.cumsum(table)
        starts = ends - table
    if starts[0] != 0 or ends[-1] != total_bits:
        raise FormatError("huffman chunks do not cover the stream")
    nwords = -(-total_bits // 32)
    if off + 4 * nwords != len(payload):
        raise FormatError("huffman payload length")
    words = np.frombuffer(payload, "<u4", nwords, off)
    return n, lengths, chunk_syms, starts, ends, \
        words.astype(">u4").view(np.uint8)


def decode_blocks(payloads: list[bytes], block_size: int,
                  dev) -> list[np.ndarray]:
    """Every chunk of every block in lockstep -> each block's bytes."""
    blocks = [parse_block(p, block_size) for p in payloads]
    tables = [code_table(b[1]) for b in blocks]
    # one stream: each block's bytes and 4 zero bytes after them
    sizes = np.array([b[5].shape[0] + 4 for b in blocks], np.int64)
    base = np.cumsum(sizes) - sizes
    stream = np.zeros(int(sizes.sum()) + 4, np.uint8)
    lanes_start, lanes_end, lanes_count, lanes_block = [], [], [], []
    for i, (n, _, chunk_syms, starts, ends, s) in enumerate(blocks):
        stream[base[i]: base[i] + s.shape[0]] = s
        c = np.arange(starts.shape[0], dtype=np.int64)
        lanes_count.append(np.clip(n - c * chunk_syms, 0, chunk_syms))
        lanes_start.append(8 * base[i] + starts)
        lanes_end.append(8 * base[i] + ends)
        lanes_block.append(np.full(starts.shape[0], i, np.int64))
    count = np.concatenate(lanes_count)
    steps = int(count.max(initial=0))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    s_t = put(stream).to(torch.int64)
    sym_t = put(np.concatenate([t[0] for t in tables]))
    len_t = put(np.concatenate([t[1] for t in tables]))
    pos = put(np.concatenate(lanes_start))
    count_t = put(count)
    tbase = put(np.concatenate(lanes_block) << MAX_LEN)
    out = torch.zeros((pos.shape[0], steps), dtype=torch.uint8, device=dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    last = s_t.shape[0] - 3
    for t in range(steps):
        on = t < count_t
        b = (pos >> 3).clamp(max=last)
        win = (s_t[b] << 16 | s_t[b + 1] << 8 | s_t[b + 2]) \
            >> (9 - (pos & 7)) & ((1 << MAX_LEN) - 1)
        length = len_t[tbase + win]
        bad |= (on & (length == 0)).any()
        out[:, t] = torch.where(on, sym_t[tbase + win], 0).to(torch.uint8)
        pos += torch.where(on, length, 0)
    if bool(bad):
        raise FormatError("huffman window with no code")
    if not np.array_equal(pos.cpu().numpy(), np.concatenate(lanes_end)):
        raise FormatError("huffman chunk ends")
    out = out.cpu().numpy()
    res, lane = [], 0
    for n, _, chunk_syms, starts, _, _ in blocks:
        k = starts.shape[0]
        res.append(out[lane: lane + k, :chunk_syms].reshape(-1)[:n])
        lane += k
    return res


def decode(container: bytes, device="cpu") -> bytes:
    """A huffman container -> the bytes it holds; raises FormatError."""
    orig_len, block_size, payloads, adler = parse_container(container, CODEC)
    return join_blocks(decode_blocks(payloads, block_size,
                                     torch.device(device)), orig_len, adler)

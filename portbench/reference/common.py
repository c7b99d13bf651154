"""Plain decoders shared by the bz and bsc references: the TPLC
container, bit-packed fields, RUNA/RUNB zero runs, move-to-front, the
inverse BWT, LZP and the record filters.

Written from the formats, in NumPy and plain PyTorch; nothing here
imports the program under test.  The array stages run on the device
they are given (the card in a benchmark run, the CPU in the tests):
move-to-front as a composition of per-chunk permutations, the inverse
BWT by pointer doubling from the primary index (the stored restart
anchors are not read).  LZP runs on the host, literal runs at a time.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

MAGIC = b"TPLC"
VERSION = 3
_HEAD = struct.Struct("<4sBBHQII")  # magic, version, codec, flags,
#                                     orig_len, block_size, nblocks
_HEAD_LEN = _HEAD.size + 8            # + data adler32 + header adler32


class FormatError(ValueError):
    """The bytes are not a valid stream of the format."""


def adler32(buf) -> int:
    return zlib.adler32(bytes(buf)) & 0xFFFFFFFF


def parse_container(buf: bytes, codec: int):
    """-> (orig_len, block_size, payloads, data_adler32); every checksum
    and size of the container is checked."""
    if len(buf) < _HEAD_LEN:
        raise FormatError("container shorter than its header")
    magic, ver, cid, _, orig_len, block_size, nblocks = _HEAD.unpack_from(buf)
    data_adler, head_adler = struct.unpack_from("<II", buf, _HEAD.size)
    if magic != MAGIC or ver != VERSION or cid != codec:
        raise FormatError(f"not a version-{VERSION} container of codec {codec}")
    if adler32(buf[: _HEAD.size + 4]) != head_adler:
        raise FormatError("header adler32")
    if orig_len and (block_size == 0 or nblocks != -(-orig_len // block_size)):
        raise FormatError("block count")
    off = _HEAD_LEN
    tables = np.frombuffer(buf, "<u4", 2 * nblocks, off).astype(np.int64)
    sizes, adlers = tables[:nblocks], tables[nblocks:]
    off += 8 * nblocks
    if int(sizes.sum()) != len(buf) - off:
        raise FormatError("payload sizes")
    payloads = []
    for size, want in zip(sizes, adlers):
        p = buf[off: off + int(size)]
        if adler32(p) != int(want):
            raise FormatError("payload adler32")
        payloads.append(p)
        off += int(size)
    return orig_len, block_size, payloads, data_adler


def join_blocks(blocks: list[np.ndarray], orig_len: int,
                data_adler: int) -> bytes:
    out = b"".join(b.tobytes() for b in blocks)
    if len(out) != orig_len or adler32(out) != data_adler:
        raise FormatError("decoded length or data adler32")
    return out


def unpack_fields(buf: bytes, width: int, count: int) -> np.ndarray:
    """`count` unsigned fields of `width` bits, MSB first -> int64."""
    if count == 0:
        return np.zeros(0, np.int64)
    need = -(-count * width // 8)
    if len(buf) < need:
        raise FormatError("truncated bit fields")
    bits = np.unpackbits(np.frombuffer(buf[:need], np.uint8))[: count * width]
    weights = 1 << np.arange(width - 1, -1, -1, dtype=np.int64)
    return bits.reshape(count, width).astype(np.int64) @ weights


def zero_runs_decode(syms: torch.Tensor) -> torch.Tensor:
    """RUNA (0) / RUNB (1) digits and literals (s >= 2 is MTF rank
    s - 1) -> the MTF ranks, int64.  A run's length is the sum of
    (digit + 1) << i over its digits i = 0, 1, ..."""
    s = syms.to(torch.int64)
    dev = s.device
    n = s.shape[0]
    if n == 0:
        return s
    i = torch.arange(n, device=dev)
    run = s <= 1
    prev_run = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                          run[:-1]])
    start = run & ~prev_run
    gid = torch.cumsum(start.to(torch.int64), 0) - 1
    first = torch.zeros(int(start.sum()) + 1, dtype=torch.int64, device=dev)
    first[gid[start]] = i[start]
    depth = torch.where(run, i - first[gid.clamp(min=0)], 0)
    if bool((depth > 40).any()):
        raise FormatError("zero run longer than 2^41")
    weight = torch.where(run, (s + 1) << depth, 0)
    total = torch.zeros(first.shape[0], dtype=torch.int64, device=dev)
    total.index_add_(0, torch.where(run, gid, first.shape[0] - 1), weight)
    reps = torch.where(start, total[gid.clamp(min=0)],
                       torch.where(run, 0, 1))
    vals = torch.where(run, 0, s - 1)
    return torch.repeat_interleave(vals, reps)


def _mtf_steps(table: torch.Tensor, ranks: torch.Tensor, want: bool):
    """Move-to-front decode of every row of `ranks` [C, K] in lockstep
    from the tables [C, 256] -> (symbols [C, K] or None, final tables)."""
    C, K = ranks.shape
    col = torch.arange(256, device=ranks.device)[None, :]
    rows = torch.arange(C, device=ranks.device)
    out = torch.empty((C, K), dtype=table.dtype, device=ranks.device) \
        if want else None
    for t in range(K):
        r = ranks[:, t]
        sym = table[rows, r]
        moved = (col >= 1) & (col <= r[:, None])
        table = torch.where(moved, torch.roll(table, 1, 1), table)
        table[:, 0] = sym
        if want:
            out[:, t] = sym
    return out, table


def mtf_decode(ranks: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Move-to-front ranks (initial table 0..255) -> bytes, uint8.

    Each chunk's table permutation is found from the identity in
    lockstep, the permutations are composed by a prefix scan to give
    each chunk its starting table, and a second lockstep pass decodes.
    """
    n = ranks.shape[0]
    dev = ranks.device
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    if bool(((ranks < 0) | (ranks > 255)).any()):
        raise FormatError("MTF rank outside 0..255")
    C = -(-n // chunk)
    r = torch.zeros(C * chunk, dtype=torch.int64, device=dev)
    r[:n] = ranks  # rank 0 leaves the table as it is
    r = r.reshape(C, chunk)
    ident = torch.arange(256, device=dev).expand(C, 256).contiguous()
    _, perm = _mtf_steps(ident, r, want=False)
    # inclusive scan: incl[c] = perm[0] o perm[1] o ... o perm[c]
    incl, d = perm, 1
    while d < C:
        nxt = incl.clone()
        nxt[d:] = torch.gather(incl[:-d], 1, incl[d:])
        incl, d = nxt, 2 * d
    start = torch.cat([ident[:1], incl[:-1]])
    syms, _ = _mtf_steps(start, r, want=True)
    return syms.reshape(-1)[:n].to(torch.uint8)


def inverse_bwt(last: torch.Tensor, idx0: int) -> torch.Tensor:
    """Inverse BWT of the whole string whose sorted rotations end in
    `last` and whose rotation 0 is row idx0 -> uint8[n].  The LF map is
    a stable sort of `last`; each row's distance to idx0 along it comes
    from pointer doubling, and row r at distance s holds the byte at
    position n - 1 - ((n - s) mod n)."""
    n = last.shape[0]
    dev = last.device
    if n == 0:
        return last
    if not 0 <= idx0 < n:
        raise FormatError("primary index outside the block")
    order = torch.sort(last.to(torch.int16), stable=True).indices
    lf = torch.empty(n, dtype=torch.int64, device=dev)
    lf[order] = torch.arange(n, device=dev)
    ptr = lf
    ptr[idx0] = idx0
    dist = torch.ones(n, dtype=torch.int64, device=dev)
    dist[idx0] = 0
    for _ in range(max(1, (n - 1).bit_length())):
        dist = dist + dist[ptr]
        ptr = ptr[ptr]
    if not bool((ptr == idx0).all()):
        raise FormatError("the LF map is not one cycle")
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    out[n - 1 - (n - dist) % n] = last
    return out


LZP_ESC = 0xF2
LZP_CTX = 8
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _ctx_hashes(out: np.ndarray, lo: int, hi: int, bits: int) -> np.ndarray:
    """Hash of the 8 bytes before each position lo..hi-1 (read as one
    little-endian 64-bit word, times the golden ratio, top `bits`)."""
    x = np.zeros(hi - lo, np.uint64)
    for k in range(LZP_CTX):
        x |= out[lo - LZP_CTX + k: hi - LZP_CTX + k].astype(np.uint64) \
            << np.uint64(8 * k)
    return (x * _GOLDEN >> np.uint64(64 - bits)).astype(np.int64)


def lzp_decode(s: np.ndarray, n: int, hash_bits: int = 18,
               min_len: int = 32) -> np.ndarray:
    """LZP stream -> n bytes.  Each position the decoder steps on (every
    literal and every match start, not a match's inside) sets its
    context's table entry; after an escape byte 0xF2 in a predicted
    context (its entry set), 0x00 is a literal 0xF2 and anything else a
    base-128 varint of (length - min_len + 1), copied from the position
    the entry holds.  Between escape bytes the stream is literal, so it
    is copied a run at a time and its entries set together."""
    m = s.shape[0]
    if m < LZP_CTX:
        raise FormatError("LZP stream shorter than its context")
    out = np.zeros(n, np.uint8)
    entry = np.full(n, -1, np.int64)  # context hash of each stepped position
    if n < LZP_CTX:
        raise FormatError("LZP output shorter than its context")
    out[:LZP_CTX] = s[:LZP_CTX]
    esc = np.flatnonzero(s == LZP_ESC)
    i = p = LZP_CTX
    while i < m:
        j = int(esc[np.searchsorted(esc, i)]) if esc.size and esc[-1] >= i \
            else m
        run = j - i
        if p + run > n:
            raise FormatError("LZP literals past the block")
        out[p: p + run] = s[i:j]
        entry[p: p + run] = _ctx_hashes(out, p, p + run, hash_bits)
        p, i = p + run, j
        if i >= m:
            break
        if p >= n:
            raise FormatError("LZP escape past the block")
        h = int(_ctx_hashes(out, p, p + 1, hash_bits)[0])
        q, hi, span = -1, p, 1 << 12
        while hi > LZP_CTX and q < 0:
            lo = max(LZP_CTX, hi - span)
            hit = np.flatnonzero(entry[lo:hi] == h)
            if hit.size:
                q = lo + int(hit[-1])
            hi, span = lo, 2 * span
        entry[p] = h
        i += 1
        if q < 0:
            out[p] = LZP_ESC
            p += 1
            continue
        if i >= m:
            raise FormatError("LZP escape at the end of the stream")
        b, i = int(s[i]), i + 1
        if b == 0:
            out[p] = LZP_ESC
            p += 1
            continue
        v, shift = 0, 0
        while b & 0x80:
            v |= (b & 0x7F) << shift
            shift += 7
            if i >= m or shift > 35:
                raise FormatError("LZP length varint")
            b, i = int(s[i]), i + 1
        length = (v | b << shift) - 1 + min_len
        if p + length > n:
            raise FormatError("LZP match past the block")
        out[p: p + length] = out[q + np.arange(length) % (p - q)]
        p += length
    if p != n:
        raise FormatError(f"LZP decoded {p} bytes, the block has {n}")
    return out


def invert_filter(block: np.ndarray, filt: int) -> np.ndarray:
    """Undo the record filter: 0 none, 1 reversed, else the record size
    of a byte-plane transpose (whole records only, the tail as is)."""
    if filt == 0:
        return block
    if filt == 1:
        return block[::-1].copy()
    body = block.shape[0] // filt * filt
    planes = block[:body].reshape(filt, -1)
    return np.concatenate([planes.T.reshape(-1), block[body:]])

"""Bit-exact .bz2 stream emitter, standard bzip2 format at levels 1-9
(port of `tpulc/codecs/bwt/bz2stream.py`: the same bytes as tpulc's
`bz2_compress` and as libbzip2's `BZ2_bzBuffToBuffCompress`, which
Python's `bz2` module runs).

The behaviours, as tpulc reimplements them from bzip2's sources:

  - RLE1 + block filling (`bzlib.c:336-440`): runs of 4-255 equal bytes
    become 4 bytes and a count, nblockMAX = 100000*level - 19, a block
    closes only between runs, and the block CRC covers the original
    bytes of the runs flushed into it.
  - MTF + RUNA/RUNB (`compress.c generateMTFValues`) over the block's
    used symbols, EOB = nInUse+1: on the block's device, K1, the start
    tables and K2 (`primitives/mtf.mtf_encode`), then `rle2_encode`.
  - Tables (`huffman.c BZ2_hbMakeCodeLengths`, `BZ2_hbAssignCodes`) and
    the six-table refinement of `compress.c sendMTFValues`: host numpy.
  - Framing: 'BZh<level>', block magic 0x314159265359, stream footer
    0x177245385090, combined CRC rotate-xor, zero bits to a byte.

tpulc splits RLE1 with a Python loop over runs and writes one numpy
array a bit field; here the split is numpy array arithmetic over runs
and the writer collects (value, width) fields and packs them once.
tpulc sorts every block at a level-derived capacity so that XLA
compiles one program; the port sorts at the block's own length.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulc_torch.codecs.bwt.masked import bwt_encode_masked
from tpulc_torch.codecs.bwt.rle import rle2_encode
from tpulc_torch.device import resolve
from tpulc_torch.primitives.checksum import crc32_bzip2_np
from tpulc_torch.primitives.mtf import DEFAULT_CHUNK, mtf_encode
from tpulc_torch.utils import timing

G_SIZE = 50
N_ITERS = 4
MAX_CODE_LEN = 17
LESSER_ICOST = 0
GREATER_ICOST = 15


class BitWriter:
    """MSB-first bit fields, packed once by `to_bytes`.  A field is a
    value below 2^width, width 0..33."""

    def __init__(self):
        self._vals: list[np.ndarray] = []
        self._widths: list[np.ndarray] = []
        self._v: list[int] = []
        self._n: list[int] = []

    def w(self, nbits: int, value: int):
        self._v.append(value)
        self._n.append(nbits)

    def w_fields(self, vals: np.ndarray, widths: np.ndarray):
        self._flush()
        self._vals.append(np.asarray(vals, np.uint64))
        self._widths.append(np.asarray(widths, np.int64))

    def _flush(self):
        if self._v:
            self._vals.append(np.array(self._v, np.uint64))
            self._widths.append(np.array(self._n, np.int64))
            self._v, self._n = [], []

    def to_bytes(self) -> bytes:
        self._flush()
        v = np.concatenate(self._vals) if self._vals else np.zeros(0, np.uint64)
        width = (np.concatenate(self._widths) if self._widths
                 else np.zeros(0, np.int64))
        total = int(width.sum())
        keep = width > 0
        v, width = v[keep], width[keep]
        off = np.cumsum(width) - width
        word = off >> 5
        # a field of <= 33 bits starting at bit (off & 31) of `word` lies
        # in the 64-bit window of words (word, word + 1)
        x = v << (64 - (off & 31) - width).astype(np.uint64)
        nw = total // 32 + 2
        # disjoint bits: a word's sum is its OR, < 2^32, exact in float64
        words = (np.bincount(word, (x >> np.uint64(32)).astype(np.float64),
                             minlength=nw)
                 + np.bincount(word + 1,
                               (x & np.uint64(0xFFFFFFFF)).astype(np.float64),
                               minlength=nw))
        return words.astype(">u4").tobytes()[: -(-total // 8)]


def rle1_split_blocks(data: np.ndarray, level: int):
    """RLE1-encode and split into blocks as bzlib does -> a list of
    (block_bytes uint8[], in_use bool[256], crc).

    Runs split into pieces of 255 (bzlib's state_in_len cap); a piece of
    L >= 4 bytes emits 5 (four bytes and L-4), shorter ones L.  A block
    closes after the piece whose emitted bytes reach nblockMAX, unless
    no piece follows; the pending piece belongs to the next block."""
    nblock_max = 100000 * level - 19
    d = np.asarray(data, np.uint8)
    n = d.shape[0]
    if n == 0:
        return []
    pstart = np.flatnonzero(np.concatenate([[True], d[1:] != d[:-1]]))
    plen = np.diff(pstart, append=n)
    if plen.max() > 255:
        pieces = (plen - 1) // 255 + 1
        run_of = np.repeat(np.arange(pstart.shape[0]), pieces)
        k = np.arange(run_of.shape[0]) - (np.cumsum(pieces) - pieces)[run_of]
        plen = np.where(k == pieces[run_of] - 1, plen[run_of] - 255 * k, 255)
        pstart = pstart[run_of] + 255 * k
    ch = d[pstart]
    emit = np.where(plen >= 4, 5, plen)
    cum = np.cumsum(emit)
    npieces = plen.shape[0]
    blocks = []
    s = 0
    while s < npieces:
        base = int(cum[s - 1]) if s else 0
        e = min(int(np.searchsorted(cum, base + nblock_max)) + 1, npieces)
        em, pl, c = emit[s:e], plen[s:e], ch[s:e]
        out = np.repeat(c, em)
        long = pl >= 4
        out[(cum[s:e] - em - base)[long] + 4] = (pl[long] - 4).astype(np.uint8)
        in_use = np.zeros(256, bool)
        in_use[c] = True
        in_use[pl[long] - 4] = True
        end = int(pstart[e]) if e < npieces else n
        blocks.append((out, in_use, crc32_bzip2_np(d[int(pstart[s]):end])))
        s = e
    return blocks


def hb_make_code_lengths(freq: np.ndarray, alpha_size: int,
                         max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Faithful BZ2_hbMakeCodeLengths: packed-weight heap, exact sift
    order, halving rescale when a code exceeds max_len."""
    weight = [0] * (alpha_size * 2 + 2)
    parent = [0] * (alpha_size * 2 + 2)
    heap = [0] * (alpha_size + 2)
    for i in range(alpha_size):
        weight[i + 1] = (int(freq[i]) if freq[i] else 1) << 8
    lengths = np.zeros(alpha_size, np.int32)

    def upheap(z):
        zz = z
        tmp = heap[zz]
        while weight[tmp] < weight[heap[zz >> 1]]:
            heap[zz] = heap[zz >> 1]
            zz >>= 1
        heap[zz] = tmp

    def downheap(z, n_heap):
        zz = z
        tmp = heap[zz]
        while True:
            yy = zz << 1
            if yy > n_heap:
                break
            if yy < n_heap and weight[heap[yy + 1]] < weight[heap[yy]]:
                yy += 1
            if weight[tmp] < weight[heap[yy]]:
                break
            heap[zz] = heap[yy]
            zz = yy
        heap[zz] = tmp

    while True:
        n_nodes = alpha_size
        n_heap = 0
        heap[0] = 0
        weight[0] = 0
        parent[0] = -2
        for i in range(1, alpha_size + 1):
            parent[i] = -1
            n_heap += 1
            heap[n_heap] = i
            upheap(n_heap)
        while n_heap > 1:
            n1 = heap[1]
            heap[1] = heap[n_heap]
            n_heap -= 1
            downheap(1, n_heap)
            n2 = heap[1]
            heap[1] = heap[n_heap]
            n_heap -= 1
            downheap(1, n_heap)
            n_nodes += 1
            parent[n1] = parent[n2] = n_nodes
            w1, w2 = weight[n1], weight[n2]
            weight[n_nodes] = (
                ((w1 & 0xFFFFFF00) + (w2 & 0xFFFFFF00))
                | (1 + max(w1 & 0xFF, w2 & 0xFF))
            )
            parent[n_nodes] = -1
            n_heap += 1
            heap[n_heap] = n_nodes
            upheap(n_heap)
        too_long = False
        for i in range(1, alpha_size + 1):
            j = 0
            k = i
            while parent[k] >= 0:
                k = parent[k]
                j += 1
            lengths[i - 1] = j
            if j > max_len:
                too_long = True
        if not too_long:
            break
        for i in range(1, alpha_size + 1):
            j = weight[i] >> 8
            weight[i] = (1 + j // 2) << 8
    return lengths


def hb_assign_codes(lengths: np.ndarray, min_len: int, max_len: int,
                    alpha_size: int) -> np.ndarray:
    code = np.zeros(alpha_size, np.int64)
    vec = 0
    for n in range(min_len, max_len + 1):
        for i in range(alpha_size):
            if lengths[i] == n:
                code[i] = vec
                vec += 1
        vec <<= 1
    return code


def _delta_fields(lens: np.ndarray):
    """One table's delta-coded lengths after its 5-bit start: per symbol
    |d| two-bit steps ('10' up, '11' down) then a '0', as one field of
    2|d|+1 <= 33 bits (lengths 1..17)."""
    d = np.diff(lens.astype(np.int64), prepend=lens[0])
    a = np.abs(d)
    up = 2 * ((np.int64(1) << 2 * a) - 1) // 3      # '10' x a
    down = (np.int64(1) << 2 * a) - 1                 # '11' x a
    return np.where(d > 0, up, down) << 1, 2 * a + 1


def _selector_mtf(selectors: np.ndarray, n_groups: int) -> np.ndarray:
    """MTF ranks of the selectors over tables 0..n_groups-1 in order: a
    table's rank is the number of other tables seen since it was last
    seen, a table never seen yet standing where the initial order puts
    it (table t as if last seen at step -1-t)."""
    n = selectors.shape[0]
    idx = np.arange(n)
    tables = np.arange(n_groups)[:, None]
    # last[t, i]: the last step before i that chose t
    seen = np.where(selectors[None, :] == tables, idx[None, :], -1 - tables)
    last = np.maximum.accumulate(seen, axis=1)
    last = np.concatenate([-1 - tables, last[:, :-1]], axis=1)
    mine = last[selectors, idx]
    return (last > mine[None, :]).sum(axis=0)


def send_mtf_values(bw: BitWriter, mtfv: np.ndarray, alpha_size: int):
    """sendMTFValues: table refinement, selectors, lengths, data bits."""
    n_mtf = len(mtfv)
    mtf_freq = np.bincount(mtfv, minlength=alpha_size)
    if n_mtf < 200:
        n_groups = 2
    elif n_mtf < 600:
        n_groups = 3
    elif n_mtf < 1200:
        n_groups = 4
    elif n_mtf < 2400:
        n_groups = 5
    else:
        n_groups = 6

    with timing.stage("bzip2.tables"):
        # initial tables by cumulative-frequency split (compress.c:283-320)
        lens = np.full((n_groups, alpha_size), GREATER_ICOST, np.int32)
        n_part = n_groups
        rem_f = n_mtf
        gs = 0
        while n_part > 0:
            t_freq = rem_f // n_part
            ge = gs - 1
            a_freq = 0
            while a_freq < t_freq and ge < alpha_size - 1:
                ge += 1
                a_freq += int(mtf_freq[ge])
            if (ge > gs and n_part != n_groups and n_part != 1
                    and (n_groups - n_part) % 2 == 1):
                a_freq -= int(mtf_freq[ge])
                ge -= 1
            lens[n_part - 1, :] = GREATER_ICOST
            lens[n_part - 1, gs: ge + 1] = LESSER_ICOST
            n_part -= 1
            gs = ge + 1
            rem_f -= a_freq

        # each 50-symbol group's histogram: a group's cost under a table
        # is its histogram times the table's lengths (integers below
        # 2^53, exact in float64), and a table's refreshed frequencies
        # are the histogram of the symbols of the groups it won
        n_sel = -(-n_mtf // G_SIZE)
        hist = np.bincount(np.arange(n_mtf) // G_SIZE * alpha_size + mtfv,
                           minlength=n_sel * alpha_size).reshape(
                               n_sel, alpha_size).astype(np.float64)

        tables = np.arange(n_groups)
        selectors = None
        for _ in range(N_ITERS):
            costs = hist @ lens.T.astype(np.float64)
            selectors = np.argmin(costs, axis=1)  # first minimum, as bzip2
            won = (selectors[None, :] == tables[:, None]).astype(np.float64)
            rf = (won @ hist).astype(np.int64)
            for t in range(n_groups):
                lens[t] = hb_make_code_lengths(rf[t], alpha_size)
        sel_mtf = _selector_mtf(selectors, n_groups)

        # assign codes
        codes = np.zeros((n_groups, alpha_size), np.int64)
        for t in range(n_groups):
            mn, mx = int(lens[t].min()), int(lens[t].max())
            if not (1 <= mn and mx <= 20):
                raise RuntimeError(f"bzip2 code lengths {mn}..{mx} out of range")
            codes[t] = hb_assign_codes(lens[t], mn, mx, alpha_size)

    with timing.stage("bzip2.emit"):
        # selectors (j ones then a zero) and tables to the stream
        bw.w(3, n_groups)
        bw.w(15, len(selectors))
        bw.w_fields((np.int64(1) << (sel_mtf + 1)) - 2, sel_mtf + 1)
        for t in range(n_groups):
            bw.w(5, int(lens[t][0]))
            bw.w_fields(*_delta_fields(lens[t]))
        # data bits per the selected tables
        sym_sel = np.repeat(selectors, G_SIZE)[:n_mtf]
        bw.w_fields(codes[sym_sel, mtfv], lens[sym_sel, mtfv])


def compress_block_bits(bw: BitWriter, block: np.ndarray,
                        in_use: np.ndarray, crc: int, dev: torch.device):
    """One block: header fields, then BWT (libbzip2's tie order), the
    symbol remap, MTF and RLE2 on `dev`; one pull of the RLE2 symbols;
    then the symbol map and `send_mtf_values` on the host."""
    bw.w(24, 0x314159)
    bw.w(24, 0x265359)
    bw.w(32, crc)
    bw.w(1, 0)  # not randomised

    n = block.shape[0]
    with timing.stage("bzip2.bwt"):
        last, idx0 = bwt_encode_masked(
            torch.from_numpy(block).to(dev), n)
    bw.w(24, idx0)

    n_in_use = int(in_use.sum())
    with timing.stage("bzip2.mtf_rle2"):
        # unseqToSeq over the used symbols; MTF and RLE2 are causal, so
        # pad to the MTF chunk and trim: the pad's rank 255 (a literal)
        # closes any trailing zero run and maps 1:1 to symbols
        seq = torch.from_numpy(np.cumsum(in_use) - 1).to(dev)
        pad = (-n) % DEFAULT_CHUNK
        remapped = torch.zeros(n + pad, dtype=torch.uint8, device=dev)
        remapped[:n] = seq[last.long()].to(torch.uint8)
        ranks = mtf_encode(remapped)
        ranks[n:] = 255
        syms, m = rle2_encode(ranks)
        mtfv = syms[: int(m) - pad].cpu().numpy().astype(np.int64)
    eob = n_in_use + 1
    mtfv = np.append(mtfv, eob)

    # symbol map
    in_use16 = in_use.reshape(16, 16).any(axis=1)
    bw.w_fields(in_use16.astype(np.uint64), np.ones(16, np.int64))
    used = in_use.reshape(16, 16)[in_use16].reshape(-1)
    bw.w_fields(used.astype(np.uint64), np.ones(used.shape[0], np.int64))

    send_mtf_values(bw, mtfv, eob + 1)


def bz2_compress(data: bytes | np.ndarray, level: int = 9,
                 device: str | torch.device | None = None) -> bytes:
    """A whole .bz2 stream at `level` (1-9), its transforms on `device`
    (default the card; raises when CUDA is asked for and absent)."""
    if not 1 <= level <= 9:
        raise ValueError(f"bzip2 level {level} not in 1..9")
    dev = resolve(device)
    arr = np.frombuffer(data, np.uint8) \
        if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    bw = BitWriter()
    for c in b"BZh":
        bw.w(8, c)
    bw.w(8, ord("0") + level)
    combined = 0
    with timing.stage("bzip2.rle1"):
        blocks = rle1_split_blocks(arr, level)
    for block, in_use, crc in blocks:
        compress_block_bits(bw, block, in_use, crc, dev)
        combined = (((combined << 1) | (combined >> 31)) ^ crc) & 0xFFFFFFFF
    bw.w(24, 0x177245)
    bw.w(24, 0x385090)
    bw.w(32, combined)
    with timing.stage("bzip2.emit"):
        return bw.to_bytes()

"""bz codec driver: BWT -> MTF -> RLE2 -> multi-table canonical Huffman
per block (port of `tpulc/codecs/bwt/driver.py`; the same container
and payload bytes).

Compress mirrors tpulc's fused per-block program (`_compress_fused`,
`driver.py:201-268`) and its payload serializer (`_encode_payloads`,
`:563-673`): transform, multi-table refinement, device package-merge,
canonical codes and bit packing all run on the block's device; the host
pulls one meta vector and the used stream words.  tpulc looks codes up
through one-hot MXU matmuls (`:174-190`); here it is a table gather.

Decompress runs ONE path for every block, single- or multi-table,
anchored or not: K3 (`huffman_walk`) decodes canonical indices per
128-symbol chunk with the chunk's table, a gather maps them to symbols
(tpulc: a one-hot MXU map, `:380-395`), then `rle2_decode`,
`mtf_decode`, and the anchored inverse BWT — or pointer doubling for
anchor-less blocks (`:777-795`).

Per-block payload (little-endian):

    n           u32   raw bytes in this block (<= cap, zero-padded)
    m           u32   RLE2 symbol count
    idx0        u32   BWT primary index
    total_bits  u32   entropy-stream bits
    mode        u8    bit0: decode anchors present; bit1: multi-table
    [K          u8    table count                      when mode&2]
    lengths     129B * K   257 code lengths each, nibble-packed
    nchunks     u32
    offset0     u32   absolute bit offset of chunk 0
    deltas      11-bit-packed * (nchunks-1)   per-chunk bit-size deltas
    [selectors  3-bit-packed * nchunks                 when mode&2]
    [n_anchors  u32 + anchors 20-bit-packed (5B/pair)  when mode&1]
    words       4B * ceil(total_bits/32)
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from tpulc_torch.codecs.bwt.multitable import refine_tables
from tpulc_torch.codecs.bwt.rle import ALPHABET, rle2_decode, rle2_encode
from tpulc_torch.codecs.bwt.rotsort import (
    bwt_decode,
    bwt_decode_anchored,
    bwt_encode_anchored,
)
from tpulc_torch.codecs.huffman.decode_kernels import huffman_walk
from tpulc_torch.codecs.huffman.device_tables import (
    canonical_codes_device,
    canonical_decode_params,
    package_merge_lengths_device,
)
from tpulc_torch.device import resolve
from tpulc_torch.pipeline.container import Container
from tpulc_torch.pipeline.registry import CODEC_BZ
from tpulc_torch.primitives.bits import (
    pack_bits,
    pack_fields_np,
    unpack_fields_np,
)
from tpulc_torch.primitives.checksum import adler32_np
from tpulc_torch.primitives.mtf import mtf_decode, mtf_encode
from tpulc_torch.utils import timing

MAX_LEN = 15
CHUNK_SYMS = 128
_BLOCK_HEAD = struct.Struct("<IIIIB")
_NIBBLES = (ALPHABET + 1) // 2 + ((ALPHABET + 1) % 2)  # 129 bytes
ANCHOR_BITS = 20  # anchors are row indices < cap <= 2^20
DELTA_BITS = 11   # chunk bit-size < CHUNK_SYMS * MAX_LEN = 1920 < 2^11
SEL_BITS = 3      # table count K <= 6
K_TABLES = 6      # refinement tables; unused ones stay empty
# Decode-restart anchor stride; both sides of a round trip share it
# (tpulc reads TPULC_ANCHOR_STRIDE, default 512; the port has no knob).
ANCHOR_STRIDE = 512


def _cap_for(block_size: int) -> int:
    return -(-block_size // 256) * 256  # MTF-chunk and CHUNK_SYMS multiple


def _fields_bytes(count: int, width: int) -> int:
    return -(-count * width // 8)


def _pack_anchors(a: np.ndarray) -> bytes:
    """uint32[R] (values < 2^20) -> ceil(R/2)*5 bytes (two per 40 bits)."""
    v = a.astype(np.uint64)
    if v.shape[0] % 2:
        v = np.concatenate([v, np.zeros(1, np.uint64)])
    pairs = v[0::2] | (v[1::2] << np.uint64(ANCHOR_BITS))
    return pairs.view(np.uint8).reshape(-1, 8)[:, :5].tobytes()


def _unpack_anchors(buf: bytes, R: int) -> np.ndarray:
    rows = np.frombuffer(buf, np.uint8).reshape(-1, 5)
    full = np.zeros((rows.shape[0], 8), np.uint8)
    full[:, :5] = rows
    pairs = full.view(np.uint64).reshape(-1)
    mask = np.uint64((1 << ANCHOR_BITS) - 1)
    out = np.empty(rows.shape[0] * 2, np.int32)
    out[0::2] = (pairs & mask).astype(np.int32)
    out[1::2] = ((pairs >> np.uint64(ANCHOR_BITS)) & mask).astype(np.int32)
    return out[:R]


def _anchor_bytes(R: int) -> int:
    return -(-R // 2) * 5


def _nibbles(lk: np.ndarray) -> bytes:
    lens_pad = np.zeros(_NIBBLES * 2, np.uint8)
    lens_pad[:ALPHABET] = lk.astype(np.uint8)
    return (lens_pad[0::2] | (lens_pad[1::2] << 4)).tobytes()


def _unpack_nibbles(nib: np.ndarray) -> np.ndarray:
    lengths = np.zeros(_NIBBLES * 2, np.int32)
    lengths[0::2] = nib & 0xF
    lengths[1::2] = nib >> 4
    return lengths[:ALPHABET]


# ------------------------------------------------------------ compress

def _forward(block: torch.Tensor):
    """The bz transform of a uint8[cap] block (tpulc's `_forward`
    without its histogram): anchored BWT -> MTF (K1, the start tables,
    K2) -> RLE2 -> (syms int32[cap], m int64 0-dim, idx0 int, anchors
    int32[R], ok bool)."""
    with timing.stage("bz.bwt"):
        last, idx0, anchors, ok = bwt_encode_anchored(block, ANCHOR_STRIDE)
    with timing.stage("bz.mtf"):
        ranks = mtf_encode(last)
    with timing.stage("bz.rle2"):
        syms, m = rle2_encode(ranks)
    return syms, m, idx0, anchors, ok


def _compress_block(block: torch.Tensor, n: int) -> bytes:
    """One zero-padded uint8[cap] block on its device -> payload bytes."""
    cap = block.shape[0]
    dev = block.device
    K = K_TABLES
    R = -(-cap // ANCHOR_STRIDE)
    nchunks = max(1, -(-cap // CHUNK_SYMS))
    out_words = -(-cap * MAX_LEN // 32)

    with timing.stage("bz.transform"):
        syms, m_t, idx0, anchors, ok = _forward(block)
        with timing.stage("bz.rle2.count"):
            m = timing.wait(int, m_t)
    with timing.stage("bz.tables"):
        with timing.stage("bz.tables.refine"):
            sel, clhist = refine_tables(syms, m, CHUNK_SYMS, K)
        with timing.stage("bz.tables.lengths"):
            hist_all = clhist.sum(dim=0)
            lens_all = package_merge_lengths_device(
                torch.cat([clhist, hist_all[None]]), MAX_LEN).to(torch.int64)
            lens_mt, lens_single = lens_all[:K], lens_all[K]
        with timing.stage("bz.tables.price"):
            used_chunks = max(1, -(-m // CHUNK_SYMS))
            live = (torch.arange(nchunks, device=dev) * CHUNK_SYMS) < m
            tab_used = torch.zeros(K, dtype=torch.int64,
                                   device=dev).scatter_reduce(
                0, torch.where(live, sel[:nchunks], 0), live.to(torch.int64),
                "amax")
            n_used, tb_mt, tb_single = timing.wait(
                torch.Tensor.tolist, torch.stack([
                    tab_used.sum(), (clhist * lens_mt).sum(),
                    (hist_all * lens_single).sum()]))
            # exact host pricing: K byte + extra length tables + selectors
            extra_bits = 8 * (1 + (n_used - 1) * _NIBBLES
                              + (used_chunks * SEL_BITS + 7) // 8)
            use_mt = ok and n_used >= 2 and tb_mt + extra_bits < tb_single
            if use_mt:
                lens_eff, sel_eff = lens_mt, sel[:nchunks]
            else:
                lens_eff = torch.zeros((K, ALPHABET), dtype=torch.int64,
                                       device=dev)
                lens_eff[0] = lens_single
                sel_eff = torch.zeros(nchunks, dtype=torch.int64, device=dev)
            codes_eff, _ = canonical_codes_device(lens_eff, MAX_LEN)
    with timing.stage("bz.entropy"):
        valid = torch.arange(cap, device=dev) < m
        ctx = torch.repeat_interleave(sel_eff, CHUNK_SYMS)[:cap]
        tab_idx = ctx * ALPHABET + syms.to(torch.int64)
        sym_lens = torch.where(valid, lens_eff.reshape(-1)[tab_idx], 0)
        sym_codes = torch.where(
            valid, codes_eff.reshape(-1).to(torch.int64)[tab_idx], 0)
        words, total_bits = pack_bits(sym_codes, sym_lens, out_words)
        off = torch.cumsum(sym_lens, 0) - sym_lens
        chunk_offsets = off.reshape(-1, CHUNK_SYMS)[:nchunks, 0]
        chunk_offsets = torch.where(live, chunk_offsets, total_bits)
    with timing.stage("bz.pull"):
        meta = timing.wait(torch.Tensor.cpu, torch.cat([
            total_bits.reshape(1), lens_eff.reshape(-1),
            anchors.to(torch.int64), sel_eff, chunk_offsets])).numpy()
        tb = int(meta[0])
        nw = -(-tb // 32)
        ent = timing.wait(torch.Tensor.cpu, words[:nw]).numpy().astype("<u4")
    with timing.stage("bz.payload"):
        o = 1
        lens_eff_np = meta[o: o + K * ALPHABET].reshape(K, ALPHABET)
        o += K * ALPHABET
        anchors_np = meta[o: o + R]
        o += R
        sels = meta[o: o + nchunks].astype(np.uint8)
        o += nchunks
        offs = meta[o: o + nchunks][:used_chunks]

        if use_mt:
            used_tabs = np.unique(sels[:used_chunks])
            remap = np.zeros(K, np.uint8)
            remap[used_tabs] = np.arange(len(used_tabs), dtype=np.uint8)
            lens = lens_eff_np[used_tabs]
        else:
            lens = lens_eff_np[:1]
        # anchors pay off only when they are a sliver of the payload
        anchored = ok and (use_mt or _anchor_bytes(R) * 20 < nw * 4)
        mode = (1 if anchored else 0) | (2 if use_mt else 0)
        payload = _BLOCK_HEAD.pack(n, m, idx0, tb, mode)
        if use_mt:
            payload += bytes([len(lens)])
        payload += b"".join(_nibbles(lk) for lk in lens)
        payload += struct.pack("<I", used_chunks)
        payload += struct.pack("<I", int(offs[0]))
        payload += pack_fields_np(np.diff(offs), DELTA_BITS)
        if use_mt:
            payload += pack_fields_np(
                remap[sels[:used_chunks]].astype(np.uint32), SEL_BITS)
        if mode & 1:
            a = anchors_np.astype(np.uint32)
            payload += struct.pack("<I", a.shape[0]) + _pack_anchors(a)
        payload += ent.tobytes()
        return payload


def compress(data: bytes | np.ndarray, block_size: int = 900_000,
             device: str | None = None) -> bytes:
    """bytes -> bz container, every block transformed on `device`
    (default "cuda"; raises when CUDA is absent)."""
    with timing.stage("bz.compress"):
        dev = resolve(device)
        arr = np.frombuffer(data, np.uint8) \
            if isinstance(data, (bytes, bytearray)) \
            else np.asarray(data, np.uint8)
        n = arr.shape[0]
        cap = _cap_for(block_size)
        payloads = []
        for i, s in enumerate(range(0, max(n, 1), block_size)):
            timing.next_block(i)
            with timing.stage("bz.block"):
                with timing.stage("bz.upload"):
                    chunk = arr[s: s + block_size]
                    block = np.zeros(cap, np.uint8)
                    block[: chunk.shape[0]] = chunk
                    block_t = timing.upload(block, dev)
                payloads.append(_compress_block(block_t, chunk.shape[0]))
        with timing.stage("bz.adler32"):
            adler = adler32_np(arr)
        with timing.stage("bz.container"):
            return Container(
                codec_id=CODEC_BZ, flags=0, orig_len=n,
                block_size=block_size, comp_sizes=[len(p) for p in payloads],
                payloads=payloads, data_adler=adler,
            ).to_bytes()


# ---------------------------------------------------------- decompress

def _parse_block(payload: bytes):
    """-> (n, m, idx0, total_bits, lengths [K, ALPHABET], sel, bit_offsets,
    anchors, words); sel is None for single-table blocks, anchors None
    for anchor-less ones."""
    n, m, idx0, total_bits, mode = _BLOCK_HEAD.unpack(
        payload[: _BLOCK_HEAD.size]
    )
    off = _BLOCK_HEAD.size
    if mode & 2:
        K = payload[off]
        off += 1
    else:
        K = 1
    lengths = np.zeros((K, ALPHABET), np.int32)
    for k in range(K):
        nib = np.frombuffer(payload[off: off + _NIBBLES], np.uint8)
        lengths[k] = _unpack_nibbles(nib)
        off += _NIBBLES
    (nchunks,) = struct.unpack("<I", payload[off: off + 4])
    off += 4
    (off0,) = struct.unpack("<I", payload[off: off + 4])
    off += 4
    db = _fields_bytes(nchunks - 1, DELTA_BITS)
    deltas = unpack_fields_np(payload[off: off + db], DELTA_BITS,
                               nchunks - 1)
    off += db
    bit_offsets = (
        off0 + np.concatenate([[0], np.cumsum(deltas)])
    ).astype(np.int32)
    sel = None
    if mode & 2:
        sb = _fields_bytes(nchunks, SEL_BITS)
        sel = unpack_fields_np(payload[off: off + sb], SEL_BITS,
                                nchunks).astype(np.uint8)
        off += sb
    anchors = None
    if mode & 1:
        (na,) = struct.unpack("<I", payload[off: off + 4])
        off += 4
        ab = _anchor_bytes(na)
        anchors = _unpack_anchors(payload[off: off + ab], na)
        off += ab
    nw = -(-total_bits // 32)
    words = np.frombuffer(payload[off: off + 4 * nw], "<u4")
    return n, m, idx0, total_bits, lengths, sel, bit_offsets, anchors, words


def walk_args(payload: bytes, cap: int, dev: torch.device):
    """Parse and validate one block payload; put K3's inputs on `dev`.

    Returns (parsed block, K3 arguments — `huffman_walk(*args)`: one
    stream, the K tables and the selectors as table indices — the
    per-chunk table selectors int64[ccap], and the K tables' canonical
    symbol orders int32[K, ALPHABET])."""
    parsed = _parse_block(payload)
    n, m, idx0, tb, lengths, sel, bit_offsets, anchors, words = parsed
    ccap = max(1, -(-cap // CHUNK_SYMS))
    K = lengths.shape[0]
    if (n > cap or m > cap or idx0 >= cap or words.shape[0] * 32 < tb
            or not 1 <= bit_offsets.shape[0] <= ccap
            or (sel is not None and int(sel.max()) >= K)):
        raise ValueError("corrupt bz block header")
    if anchors is None and sel is not None:
        raise ValueError("multi-table blocks always carry anchors")
    if anchors is not None and anchors.shape[0] != -(-cap // ANCHOR_STRIDE):
        raise ValueError("bz block anchor count does not match its cap")
    lim, base, ss = canonical_decode_params(
        timing.upload(lengths, dev), MAX_LEN)
    sel_p = np.zeros(ccap, np.int64)
    if sel is not None:
        sel_p[: sel.shape[0]] = sel
    offs_p = np.full(ccap, tb, np.int32)
    offs_p[: bit_offsets.shape[0]] = bit_offsets
    sel_t = timing.upload(sel_p, dev)
    args = (timing.upload(words.view(np.int32).copy(), dev)[None],
            timing.upload(torch.tensor([tb], dtype=torch.int32), dev),
            timing.upload(offs_p, dev),
            lim, base, sel_t.to(torch.int32), CHUNK_SYMS, MAX_LEN)
    return parsed, args, sel_t, ss


def _decompress_block(payload: bytes, cap: int, dev: torch.device):
    with timing.stage("bz.walk"):
        with timing.stage("bz.parse"):
            parsed, args, sel_t, ss = walk_args(payload, cap, dev)
            n, m, idx0, _, _, _, _, anchors, _ = parsed
        with timing.stage("bz.huffman"):
            ci = huffman_walk(*args)
            flat = ci.reshape(-1)[:cap].clamp(0, ALPHABET - 1).to(torch.int64)
            ctx = torch.repeat_interleave(sel_t, CHUNK_SYMS)[:cap]
            syms = ss.reshape(-1)[ctx * ALPHABET + flat]
    with timing.stage("bz.inverse"):
        with timing.stage("bz.rle2.decode"):
            ranks, _ = rle2_decode(syms, m)
        with timing.stage("bz.mtf.decode"):
            last = mtf_decode(ranks)
        with timing.stage("bz.ibwt"):
            if anchors is not None:
                out = bwt_decode_anchored(
                    last, timing.upload(anchors, dev),
                    ANCHOR_STRIDE)
            else:
                out = bwt_decode(last, idx0)
    with timing.stage("bz.pull"):
        return timing.wait(torch.Tensor.cpu, out[:n]).numpy()


def decompress(buf: bytes, device: str | None = None) -> bytes:
    """bz container -> bytes, every block decoded on `device` (default
    "cuda"; raises when CUDA is absent)."""
    with timing.stage("bz.decompress"):
        dev = resolve(device)
        with timing.stage("bz.container"):
            c = Container.from_bytes(buf)
        if c.codec_id != CODEC_BZ:
            raise ValueError(f"not a bz container (codec {c.codec_id})")
        cap = _cap_for(c.block_size)
        parts = []
        for i, p in enumerate(c.payloads):
            timing.next_block(i)
            with timing.stage("bz.block"):
                parts.append(_decompress_block(p, cap, dev))
        with timing.stage("bz.join"):
            out = b"".join(x.tobytes() for x in parts)[: c.orig_len]
        with timing.stage("bz.adler32"):
            ok = c.verify_data(np.frombuffer(out, np.uint8))
        if not ok:
            raise ValueError("data checksum mismatch after decompress")
        return out

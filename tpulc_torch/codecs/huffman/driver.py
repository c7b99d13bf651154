"""Huffman codec driver (port of `tpulc/codecs/huffman/driver.py`; the
same container and payload bytes).

Per-block payload layout (little-endian):

    n           u32   symbols in this block
    total_bits  u32   valid bits in the codeword stream
    mode        u8    1: v1 aligned table; 2: v2 aligned table; 0: none
    lengths     128B  256 code lengths, nibble-packed (max_len <= 15)
    [v1: nchunks u32, offsets u32 * nchunks   absolute chunk bit offsets]
    [v2: chunk_log u8, nchunks u32, deltas u16 * nchunks   chunk bit sizes]
    words       4B * ceil(total_bits/32)  MSB-first codeword stream

A chunk is CHUNK_SYMS (v1) or 2^chunk_log (v2) symbols.  Without an
aligned table the self-synchronising decoder recovers the partition.

Compress is one batched program per group of up to GROUP blocks
(tpulc's `compress_batched`): histogram, package-merge and canonical
codes on the device, a packed (code, length) table gather, `pack_bits`
and chunk offsets; the host pulls the small results and the used stream
words and writes the payloads.  Decompress parses a group of aligned
blocks into one batch and decodes it with one of four decoders
(`decode_batch_device`); a group with a block lacking the aligned
table, or with mixed chunk sizes, falls back to one block at a time.
Every group's symbols are copied from the device into one host array,
which the checksum reads in place and `bytes` copies once.

tpulc pads batches to compile-cache buckets (power-of-two block counts,
`w_pad` word buckets, a backend-dependent MAX_BATCH); the port decodes
exactly the blocks of a group, with GROUP = 128 on every device.  The
container bytes do not depend on it.

Spans (`utils/timing.py`): the roots `huffman.compress` and
`huffman.decompress`; `huffman.group` a group (block index: its first
block); the coarse stages `huffman.encode`, `huffman.pull`,
`huffman.parse` and `huffman.decode`, with `huffman.upload`,
`huffman.histogram`, `huffman.lengths`, `huffman.codes` and
`huffman.pack` inside `huffman.encode`, `huffman.upload` inside
`huffman.parse`, and `huffman.tables`, `huffman.walk` and
`huffman.symbols` inside `huffman.decode` (`decode.py`'s K3, K7 and K8
decoders); host work in `huffman.payload`, `huffman.container`,
`huffman.join` and `huffman.adler32`.  Every blocking read of the card
goes through `timing.wait` or `timing.upload`.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from tpulc_torch.codecs.huffman import decode as hdec
from tpulc_torch.codecs.huffman.autotune import optimal_sub_bits
from tpulc_torch.codecs.huffman.device_tables import (
    canonical_codes_device,
    package_merge_lengths_device,
)
from tpulc_torch.codecs.huffman.tables import DEFAULT_MAX_LEN, HuffmanTable
from tpulc_torch.device import resolve
from tpulc_torch.pipeline.container import Container
from tpulc_torch.pipeline.registry import CODEC_HUFFMAN
from tpulc_torch.primitives.bits import pack_bits
from tpulc_torch.primitives.checksum import adler32_np
from tpulc_torch.utils import timing

CHUNK_SYMS = 256      # v1 wire mode (32-bit absolute offsets)
CHUNK_SYMS_V2 = 128   # v2 wire mode (16-bit offset deltas)
_BLOCK_HEAD = struct.Struct("<IIB")

FLAG_ALIGNED = 1
FLAG_ALIGNED2 = 2     # per-chunk u16 bit-length deltas + chunk_log u8

GROUP = 128           # blocks per device program (encode and decode)
KERNELS = ("ranks", "v1", "buffered", "flat")


def _check_chunking(aligned: bool, chunk_syms: int, max_len: int) -> None:
    if aligned and (chunk_syms < 1 or chunk_syms & (chunk_syms - 1)):
        raise ValueError(f"chunk_syms={chunk_syms} must be a power of two")
    if aligned and chunk_syms % 8 != 0:
        raise ValueError(f"chunk_syms={chunk_syms} must be a multiple of 8 "
                         "(decode kernel constraint)")
    if aligned and chunk_syms != CHUNK_SYMS and chunk_syms * max_len >= 1 << 16:
        raise ValueError(f"chunk_syms={chunk_syms}: a v2 chunk's bit size "
                         "must fit its u16 delta")


# ------------------------------------------------------------ compress

def _encode_batch(blocks: torch.Tensor, ns: torch.Tensor, out_words: int,
                  nchunks: int, chunk_syms: int, max_len: int):
    """Whole-group encode on the blocks' device: uint8 [B, cap] blocks,
    int64 [B] symbol counts -> (words int64[B, out_words], total_bits
    int64[B], chunk_offsets int64[B, nchunks], lengths int32[B, 256])."""
    B, cap = blocks.shape
    dev = blocks.device
    with timing.stage("huffman.histogram"):
        idx = blocks.to(torch.int64)
        valid = torch.arange(cap, device=dev)[None, :] < ns[:, None]
        freqs = torch.zeros((B, 257), dtype=torch.int64, device=dev)
        freqs.scatter_add_(1, torch.where(valid, idx, 256),
                           torch.ones_like(idx))
    with timing.stage("huffman.lengths"):
        lens = package_merge_lengths_device(freqs[:, :256], max_len)
    with timing.stage("huffman.codes"):
        codes, lens = canonical_codes_device(lens, max_len)
        # one packed (code << 5 | len) table -> one per-symbol gather
        table = (codes.to(torch.int64) << 5) | lens.to(torch.int64)
        packed = torch.where(valid, torch.gather(table, 1, idx), 0)
        del idx
    with timing.stage("huffman.pack"):
        sym_lens = packed & 31
        words, total_bits = pack_bits(packed >> 5, sym_lens, out_words)
        del packed
        off = torch.cumsum(sym_lens, 1) - sym_lens
        chunk_offsets = off[:, ::chunk_syms][:, :nchunks]
        chunk_valid = (torch.arange(nchunks, device=dev)[None, :] * chunk_syms
                       < ns[:, None])
        chunk_offsets = torch.where(chunk_valid, chunk_offsets,
                                    total_bits[:, None])
    return words, total_bits, chunk_offsets, lens


def _payload_from(nsym: int, total_bits: int, lens_np: np.ndarray,
                  offs_np: np.ndarray, words_np: np.ndarray, aligned: bool,
                  chunk_syms: int) -> bytes:
    """Assemble one block payload from pulled results."""
    v2 = chunk_syms != CHUNK_SYMS
    lens8 = lens_np.astype(np.uint8)
    nibbles = (lens8[0::2] | (lens8[1::2] << 4)).tobytes()
    mode = (FLAG_ALIGNED2 if v2 else FLAG_ALIGNED) if aligned else 0
    payload = _BLOCK_HEAD.pack(nsym, total_bits, mode) + nibbles
    if aligned:
        used_chunks = max(1, -(-nsym // chunk_syms))
        offs = offs_np[:used_chunks].astype(np.int64)
        if v2:
            ends = np.append(offs[1:], total_bits)
            deltas = (ends - offs).astype("<u2")
            payload += struct.pack(
                "<BI", chunk_syms.bit_length() - 1, used_chunks
            ) + deltas.tobytes()
        else:
            payload += struct.pack("<I", used_chunks) \
                + offs.astype("<u4").tobytes()
    nw = -(-total_bits // 32)
    payload += words_np[:nw].astype("<u4").tobytes()
    return payload


def _encode_payloads(blocks: np.ndarray, ns: list[int], dev: torch.device,
                     max_len: int, aligned: bool,
                     chunk_syms: int) -> list[bytes]:
    """uint8 [B, cap] zero-padded blocks -> B payloads (one device
    program, one pull of the small results, one of the used words)."""
    B, cap = blocks.shape
    out_words = -(-cap * max_len // 32)
    nchunks = max(1, -(-cap // chunk_syms))
    with timing.stage("huffman.encode"):
        with timing.stage("huffman.upload"):
            blocks_t = timing.upload(blocks, dev)
            ns_t = timing.upload(np.asarray(ns, np.int64), dev)
        words, tbits, offs, lens = _encode_batch(
            blocks_t, ns_t, out_words, nchunks, chunk_syms, max_len)
        del blocks_t
    with timing.stage("huffman.pull"):
        meta = timing.wait(torch.Tensor.cpu, torch.cat(
            [tbits[:, None], offs, lens.to(torch.int64)], 1)).numpy()
        take = min(out_words, max(1, -(-int(meta[:, 0].max()) // 32)))
        words_np = timing.wait(torch.Tensor.cpu, words[:, :take]).numpy()
    with timing.stage("huffman.payload"):
        return [_payload_from(ns[j], int(meta[j, 0]), meta[j, 1 + nchunks:],
                              meta[j, 1: 1 + nchunks], words_np[j], aligned,
                              chunk_syms)
                for j in range(B)]


def compress_block(block: np.ndarray, max_len: int = DEFAULT_MAX_LEN,
                   block_cap: int | None = None, aligned: bool = True,
                   chunk_syms: int = CHUNK_SYMS_V2,
                   device: str | None = None) -> bytes:
    """Compress one block (uint8) to a payload, zero-padded to
    `block_cap` symbols; `chunk_syms` 256 writes the v1 wire, any other
    power of two the v2 wire."""
    dev = resolve(device)
    _check_chunking(aligned, chunk_syms, max_len)
    block = np.asarray(block, np.uint8)
    n = block.shape[0]
    cap = max(1, block_cap or n)
    if n > cap:
        raise ValueError(f"block of {n} bytes exceeds block_cap {cap}")
    padded = np.zeros((1, cap), np.uint8)
    padded[0, :n] = block
    return _encode_payloads(padded, [n], dev, max_len, aligned,
                            chunk_syms)[0]


def compress(data: bytes | np.ndarray, block_size: int = 1 << 20,
             max_len: int = DEFAULT_MAX_LEN, aligned: bool = True,
             chunk_syms: int = CHUNK_SYMS_V2,
             device: str | None = None) -> bytes:
    """bytes -> huffman container, GROUP blocks per device program on
    `device` (default "cuda"; raises when CUDA is absent)."""
    with timing.stage("huffman.compress"):
        dev = resolve(device)
        _check_chunking(aligned, chunk_syms, max_len)
        arr = np.frombuffer(data, np.uint8) \
            if isinstance(data, (bytes, bytearray)) \
            else np.asarray(data, np.uint8)
        n = arr.shape[0]
        nblocks = max(1, -(-n // block_size))
        payloads = []
        for g in range(0, nblocks, GROUP):
            timing.next_block(g)
            with timing.stage("huffman.group"):
                B = min(GROUP, nblocks - g)
                seg = arr[g * block_size: (g + B) * block_size]
                blocks = np.zeros(B * block_size, np.uint8)
                blocks[: seg.shape[0]] = seg
                ns = [min(block_size, max(0, seg.shape[0] - j * block_size))
                      for j in range(B)]
                payloads += _encode_payloads(
                    blocks.reshape(B, block_size), ns, dev, max_len, aligned,
                    chunk_syms)
        with timing.stage("huffman.adler32"):
            adler = adler32_np(arr)
        with timing.stage("huffman.container"):
            return Container(
                codec_id=CODEC_HUFFMAN, flags=FLAG_ALIGNED if aligned else 0,
                orig_len=n, block_size=block_size,
                comp_sizes=[len(p) for p in payloads], payloads=payloads,
                data_adler=adler,
            ).to_bytes()


# ---------------------------------------------------------- decompress

def _parse_payload(payload: bytes):
    """-> (n, total_bits, lengths int32[256], bit_offsets uint32[nchunks]
    or None, chunk_syms or None, words uint32[nw]).

    Raises ValueError on a payload that does not hold together: a v2
    `chunk_log` whose chunk is not a multiple of 8 symbols, a chunk count
    that disagrees with n, or fields past the payload's end (tpulc
    decodes such payloads to wrong output).  The chunk table and the
    words are views of the payload's memory."""
    head = _BLOCK_HEAD.size + 128
    if len(payload) < head:
        raise ValueError("truncated huffman block header")
    view = memoryview(payload)
    n, total_bits, mode = _BLOCK_HEAD.unpack_from(view)
    nib = np.frombuffer(view[_BLOCK_HEAD.size: head], np.uint8)
    lengths = np.zeros(256, np.int32)
    lengths[0::2] = nib & 0xF
    lengths[1::2] = nib >> 4
    off = head
    bit_offsets = chunk_syms = None
    if mode & (FLAG_ALIGNED | FLAG_ALIGNED2):
        if mode & FLAG_ALIGNED2:
            if len(payload) < off + 5:
                raise ValueError("truncated huffman chunk table")
            chunk_log, nchunks = struct.unpack_from("<BI", view, off)
            off += 5
            chunk_syms = 1 << chunk_log
            if chunk_syms % 8 != 0:
                raise ValueError(f"chunk_log {chunk_log}: chunks of "
                                 f"{chunk_syms} symbols are not a multiple "
                                 "of 8")
            width = 2
        else:
            if len(payload) < off + 4:
                raise ValueError("truncated huffman chunk table")
            (nchunks,) = struct.unpack_from("<I", view, off)
            off += 4
            chunk_syms = CHUNK_SYMS
            width = 4
        if nchunks != max(1, -(-n // chunk_syms)):
            raise ValueError(f"{nchunks} chunks do not match {n} symbols "
                             f"in chunks of {chunk_syms}")
        if len(payload) < off + width * nchunks:
            raise ValueError("truncated huffman chunk table")
        raw = np.frombuffer(view[off: off + width * nchunks],
                            "<u2" if width == 2 else "<u4")
        off += width * nchunks
        if width == 2:
            raw = np.cumsum(raw.astype(np.int64)) - raw
        bit_offsets = raw.astype(np.uint32)
    nw = -(-total_bits // 32)
    if len(payload) < off + 4 * nw:
        raise ValueError("truncated huffman codeword stream")
    words = np.frombuffer(view[off: off + 4 * nw], "<u4")
    return n, total_bits, lengths, bit_offsets, chunk_syms, words


def _batch_arrays(parsed: list, cap: int):
    """Parsed aligned blocks of one chunk size -> (words uint32[B, W],
    tbits int32[B], lengths int32[B, 256], offs uint32[B, ccap]), with W
    and ccap the group's largest stream and chunk count (tpulc sizes
    ccap from the block size; symbols past a block's n are trimmed
    either way).  Chunks past a block's last carry offset total_bits
    (an empty range)."""
    B = len(parsed)
    W = max(1, max(p[5].shape[0] for p in parsed))
    ccap = max(p[3].shape[0] for p in parsed)
    words = np.zeros((B, W), np.uint32)
    tbits = np.zeros(B, np.int32)
    lens = np.zeros((B, 256), np.int32)
    offs = np.zeros((B, ccap), np.uint32)
    for j, (n, tb, ln, bit_offsets, _, w) in enumerate(parsed):
        if n > cap or tb >= 2 ** 31:
            raise ValueError("huffman block exceeds the container's "
                             "block size")
        words[j, : w.shape[0]] = w
        tbits[j] = tb
        lens[j] = ln
        offs[j, :] = tb
        offs[j, : bit_offsets.shape[0]] = bit_offsets
    return words, tbits, lens, offs


def _parse_aligned_group(group: list[bytes], cap: int):
    """A payload group -> (words, tbits, lengths, offs, ns, chunk_syms)
    numpy batch arrays (see `_batch_arrays`), or None when a block lacks
    the aligned table or the chunk sizes differ (per-block fallback)."""
    parsed = [_parse_payload(p) for p in group]
    sizes = {p[4] for p in parsed}
    if None in sizes or len(sizes) != 1:
        return None
    chunk_syms = sizes.pop()
    return (*_batch_arrays(parsed, cap), [p[0] for p in parsed], chunk_syms)


def decode_batch_device(words: torch.Tensor, tbits: torch.Tensor,
                        lengths: torch.Tensor, offs: torch.Tensor,
                        chunk: int, max_len: int,
                        kernel: str | None = None) -> torch.Tensor:
    """Decode one parsed aligned batch on its tensors' device -> uint8
    [B, ccap*chunk], without pulling it to the host.

    words int32[B, W] (uint32 bit patterns), tbits int32[B], lengths
    int32[B, 256], offs int32[B, ccap].  `kernel` picks the decoder —
    ranks (plain torch), v1 (K7), buffered (K3 packed) or flat (K8);
    without it TPULC_HUFF_KERNEL does, as in tpulc, and the default is
    buffered on every device (the plain K3 on the CPU)."""
    kern = kernel if kernel is not None else os.environ.get(
        "TPULC_HUFF_KERNEL", "buffered")
    if kern not in KERNELS:
        raise ValueError(
            f"TPULC_HUFF_KERNEL={kern!r}: expected ranks|v1|buffered|flat")
    fn = {"ranks": hdec.huffman_decode_ranks_batch,
          "v1": hdec.huffman_decode_pallas_batch,
          "buffered": hdec.huffman_decode_buffered_batch,
          "flat": hdec.huffman_decode_flat_batch}[kern]
    return fn(words, tbits, lengths, offs, chunk, max_len)


def _to_device(words, tbits, lens, offs, dev):
    return (timing.upload(words.view(np.int32), dev),
            timing.upload(tbits, dev), timing.upload(lens, dev),
            timing.upload(offs.view(np.int32), dev))


def _pull_into(out: np.ndarray, syms: torch.Tensor) -> int:
    """Copy the 1-D uint8 `syms` into the front of the host array `out`,
    as far as `out` reaches: one copy from the device, a wait (none for
    no bytes: an empty copy does not synchronise).  -> the bytes
    written."""
    n = min(syms.shape[0], out.shape[0])
    if n:
        timing.wait(torch.Tensor.copy_, torch.from_numpy(out[:n]), syms[:n])
    return n


def _valid_symbols(syms: torch.Tensor, ns: list[int]) -> torch.Tensor:
    """uint8 [B, width] decoded rows -> each row's first ns[j] symbols,
    one block after another, as one 1-D tensor on the rows' device.
    Where every block but the last holds ns[0] symbols (any container's
    group), that is a prefix of the rows cut to ns[0]: a view when ns[0]
    is the row width (1 MiB blocks of 128-symbol chunks), else one
    narrowing copy on the device."""
    width = ns[0]
    if all(n == width for n in ns[:-1]) and ns[-1] <= width:
        return syms[:, :width].reshape(-1)[: sum(ns)]
    return torch.cat([syms[j, :n] for j, n in enumerate(ns)])


def _decompress_batch_aligned(group: list[bytes], cap: int, max_len: int,
                              dev: torch.device, kernel: str | None,
                              out: np.ndarray) -> int | None:
    """All-aligned fast path: the whole group decodes in one batch, and
    its blocks' symbols land one after another at the front of `out` (as
    far as it reaches).  Returns the bytes written, or None when the
    group must fall back to one block at a time."""
    with timing.stage("huffman.parse"):
        prep = _parse_aligned_group(group, cap)
        if prep is None:
            return None
        words, tbits, lens, offs, ns, chunk = prep
        with timing.stage("huffman.upload"):
            args = _to_device(words, tbits, lens, offs, dev)
    with timing.stage("huffman.decode"):
        syms = decode_batch_device(*args, chunk, max_len, kernel)
    with timing.stage("huffman.pull"):
        return _pull_into(out, _valid_symbols(syms, ns))


def _decode_block(payload: bytes, max_len: int, block_cap: int | None,
                  dev: torch.device, kernel: str | None) -> torch.Tensor:
    """One payload -> its uint8 symbols on `dev`: aligned blocks through
    `decode_batch_device` as a batch of one, others through the
    self-synchronising decoder."""
    parsed = _parse_payload(payload)
    n, total_bits, lengths, bit_offsets, chunk_syms, words = parsed
    cap = block_cap or n
    if bit_offsets is not None:
        args = _to_device(*_batch_arrays([parsed], cap), dev)
        return decode_batch_device(*args, chunk_syms, max_len, kernel)[0, :n]
    if n > cap:
        raise ValueError("huffman block exceeds the container's block size")
    table = HuffmanTable.from_lengths(lengths, max_len)
    sub_bits = optimal_sub_bits(total_bits, n, max_len)
    out, n_valid = hdec.huffman_decode(
        timing.upload(words.astype(np.int64), dev), total_bits, cap,
        timing.upload(table.lut_sym.astype(np.int64), dev),
        timing.upload(table.lut_len.astype(np.int64), dev), max_len,
        sub_bits)
    if n_valid < n:
        raise ValueError(f"self-sync decode found {n_valid} of {n} symbols")
    return out[:n]


def decompress_block(payload: bytes, max_len: int = DEFAULT_MAX_LEN,
                     block_cap: int | None = None, device: str | None = None,
                     kernel: str | None = None) -> np.ndarray:
    """One payload -> uint8 symbols (see `_decode_block`)."""
    syms = _decode_block(payload, max_len, block_cap, resolve(device), kernel)
    out = np.empty(syms.shape[0], np.uint8)
    _pull_into(out, syms)
    return out


def decompress(buf: bytes, max_len: int = DEFAULT_MAX_LEN,
               device: str | None = None, kernel: str | None = None) -> bytes:
    """huffman container -> bytes, decoded on `device` (default "cuda";
    raises when CUDA is absent) with the decoder `kernel` picks (see
    `decode_batch_device`)."""
    with timing.stage("huffman.decompress"):
        dev = resolve(device)
        with timing.stage("huffman.container"):
            c = Container.from_bytes(buf)
        if c.codec_id != CODEC_HUFFMAN:
            raise ValueError(f"not a huffman container (codec {c.codec_id})")
        out = np.empty(c.orig_len, np.uint8)
        pos = 0
        for i in range(0, len(c.payloads), GROUP):
            timing.next_block(i)
            with timing.stage("huffman.group"):
                group = c.payloads[i: i + GROUP]
                got = _decompress_batch_aligned(group, c.block_size, max_len,
                                                dev, kernel, out[pos:])
                if got is None:
                    got = 0
                    for p in group:
                        got += _pull_into(out[pos + got:], _decode_block(
                            p, max_len, c.block_size, dev, kernel))
                pos += got
        with timing.stage("huffman.join"):
            out = out[:pos].tobytes()
        with timing.stage("huffman.adler32"):
            ok = c.verify_data(out)
        if not ok:
            raise ValueError("data checksum mismatch after decompress")
        return out

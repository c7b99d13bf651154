"""bsc-class large-block codec, the `-e2` path on the BWT sorter (port
of `tpulc/codecs/bsclike/driver.py`; the same container and payload
bytes).

Compress, per block: the entropy-model segmentation gate, the filter
choice, host LZP (`gold/lzp.c`), the masked BWT + anchors and MTF on
the block's device (`bwt/masked.py`: K1, K2), then the group-rank coder
(`grc.py`: K5) and the payload, or the stored fallback when coding does
not shrink the block.  Decompress: K6 decodes the ranks, MTF decode (K4)
and the anchored masked inverse BWT (or pointer doubling for
anchor-less blocks) rebuild the LZP stage, then LZP decode and the
inverse filter on the host.

Not ported yet, each raising `NotImplementedError` that names its
ROADMAP item: coder 1 (`-e1`, tpulc's default; `rans.py` and the
batched path `driver.py:969-1173`), `CODER_ABC` payloads and the ST
sorters (`rans_adaptive.py`, `bwt/stk.py`).

Per-block payload (little-endian), as tpulc writes it for coder 2:

    n           u32   raw bytes in this block
    m_lzp       u32   LZP-stage bytes (== n when LZP was skipped)
    m           u32   == m_lzp (the group coder reads the MTF stream)
    idx0        u32   BWT primary index
    nwords      u32   total rANS u16 words (segment count when segmented)
    flags       u8    bit0 LZP applied; bit1 stored raw; bit3 anchors;
                      bits4-6 sorter (0 = BWT); bit7 filter byte
    coder       u8    4 = group-rank coder, 3 = segmented wrapper
    [filter     u8    when flags bit7]
    [anchors    ceil(log2(cap))-bit-packed, ceil(m_lzp/1024)   when bit3]
    inits       NM-bit bitmap of used models + u16 per used model
    cinits      u16 * NFAM
    maxbits     u32   deepest lane's event count (decode loop bound)
    nlanes      u32
    counts      u16 * nlanes   per-lane word counts
    states      u32 * nlanes   final rANS states
    words       u16 * nwords   per-lane streams back to back
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from tpulc_torch.codecs.bsclike import grc as G
from tpulc_torch.codecs.bsclike.filters import (
    FILTER_NONE,
    apply_filter_np,
    detect_record_size,
    detect_segments_gated,
    invert_filter_np,
)
from tpulc_torch.codecs.bsclike.grc_kernels import grc_decode_walk
from tpulc_torch.codecs.bwt.masked import (
    forward_ranks_anchored,
    inverse_ranks,
    inverse_ranks_anchored,
)
from tpulc_torch.device import resolve
from tpulc_torch.gold.lzp import lzp_decode, lzp_encode
from tpulc_torch.pipeline.container import Container
from tpulc_torch.pipeline.registry import CODEC_BSC
from tpulc_torch.primitives.bits import pack_fields_np, unpack_fields_np
from tpulc_torch.primitives.checksum import adler32_np
from tpulc_torch.utils import timing

DEFAULT_BLOCK = 25 * 1024 * 1024
ANCHOR_STRIDE = 1024  # bsc blocks are large; halve anchor count
# lane sizes of tpulc's two coders (rans.CHUNK, rans_adaptive.ACHUNK):
# block capacities and transform buckets tile to both
CHUNK = 512
ACHUNK = 1024

_HEAD = struct.Struct("<IIIIIBB")  # ..., flags, coder
# coder byte (libbsc's `-e` switch): 1 = static order-2 context rANS,
# 2 = adaptive binary rANS (tpulc writes it only for ST sorters), 4 =
# group-rank coder (the `-e2` stream on the BWT sorter), 3 = segmented
# wrapper (header nwords field = segment count, then u32 sub-payload
# sizes and the sub-payloads)
CODER_RANS = 1
CODER_ABC = 2
CODER_SEGMENTED = 3
CODER_GRC = 4
FLAG_LZP = 1
FLAG_STORED = 2
FLAG_ANCHORS = 8
SORTER_SHIFT = 4
SORTER_MASK = 0x7 << SORTER_SHIFT
FLAG_FILTER = 0x80

_E1 = "ROADMAP queue 1 item 10 (bsc -e1: rans.py)"
_ST = "ROADMAP queue 1 item 10 (bsc ST sorters: bwt/stk.py, rans_adaptive.py)"


def _filter_byte_for(block: np.ndarray, filter_mode: str) -> int:
    if filter_mode == "none":
        return FILTER_NONE
    if filter_mode == "reverse":
        return 1
    if filter_mode.startswith("reorder:"):
        rs = int(filter_mode.split(":", 1)[1])
        if not 2 <= rs <= 255:
            raise ValueError("reorder record size must be in 2..255")
        return rs
    if filter_mode == "auto":
        return detect_record_size(block)
    raise ValueError(f"unknown filter {filter_mode!r} "
                     "(none, reverse, reorder:N, auto)")


def _cap_for(block_size: int) -> int:
    q = max(64, CHUNK, ACHUNK)
    return -(-block_size // q) * q


def _tcap_for(nbytes: int, cap: int) -> int:
    """Transform-shape bucket: power of two >= nbytes, clamped to cap
    (LZP often shrinks a block several-fold; encode and decode bucket
    independently, the wire carries explicit counts)."""
    t = max(64, CHUNK, ACHUNK)
    while t < nbytes:
        t *= 2
    return min(t, cap)


def _check_coder(sorter: str, coder: int) -> None:
    if sorter != "bwt":
        raise NotImplementedError(
            f"bsc sorter {sorter!r} is not ported to tpulc_torch yet: {_ST}")
    if coder == CODER_RANS:
        raise NotImplementedError(
            f"bsc coder 1 is not ported to tpulc_torch yet: {_E1}")
    if coder not in (CODER_ABC, CODER_GRC):
        raise ValueError(f"unknown bsc coder {coder}")


# ------------------------------------------------------------ compress

def _finish_block_grc(ranks, idx0, anchors, a_ok, orig_block, n, m_lzp,
                      cap, flags, fb) -> bytes:
    """Group-rank coding + payload assembly (tpulc `:397-468`)."""
    with timing.stage("bsc.rans"):
        lane_bits, _ = G.grc_lane_bits(ranks, m_lzp)
        maxbits = int(lane_bits.max()) if lane_bits.numel() else 0
        W = G.bucket_bits(max(maxbits, 1))
        words, counts, states, inits_d, cinits_d, tot_d = G.grc_encode(
            ranks, m_lzp, W)
        used = max(1, -(-m_lzp // G.GCHUNK))
        meta = torch.cat([counts[:used], states[:used],
                          inits_d.to(torch.int64), cinits_d.to(torch.int64),
                          tot_d]).cpu().numpy()
        counts_np = meta[:used]
        states_np = meta[used: 2 * used].astype("<u4")
        o = 2 * used
        inits = meta[o: o + G.NM].astype(np.uint16)
        cinits = meta[o + G.NM: o + G.NM + G.NFAM].astype(np.uint16)
        tot = meta[o + G.NM + G.NFAM:]
        wmax = int(counts_np.max(initial=0))
        words_np = words[:used, :wmax].cpu().numpy()
    nwords = int(counts_np.sum())
    inits_b = G.pack_inits(inits, tot)
    r_used = max(1, -(-m_lzp // ANCHOR_STRIDE))
    aw = max(1, int(cap - 1).bit_length())
    body_size = _HEAD.size + len(inits_b) + 2 * G.NFAM + 8 + 6 * used \
        + 2 * nwords + (-(-r_used * aw // 8) if a_ok else 0)
    if body_size >= n:
        return _HEAD.pack(n, n, 0, 0, 0, FLAG_STORED, CODER_GRC) \
            + orig_block.tobytes()
    lane_valid = np.arange(wmax)[None, :] < counts_np[:, None]
    flat = words_np[lane_valid].astype("<u2")
    if a_ok:
        flags |= FLAG_ANCHORS
    payload = _HEAD.pack(n, m_lzp, m_lzp, idx0, nwords, flags, CODER_GRC)
    if flags & FLAG_FILTER:
        payload += bytes([fb])
    if a_ok:
        payload += pack_fields_np(anchors[:r_used].cpu().numpy(), aw)
    payload += inits_b
    payload += cinits.astype("<u2").tobytes()
    payload += struct.pack("<II", maxbits, used)
    payload += counts_np.astype("<u2").tobytes()
    payload += states_np.tobytes()
    payload += flat.tobytes()
    return payload


def compress_block(block: np.ndarray, block_cap: int, use_lzp: bool = True,
                   sorter: str = "bwt", filter_mode: str = "auto",
                   coder: int = CODER_ABC, _segments=None,
                   device: str | None = None) -> bytes:
    """One block -> payload (segmented when the detector splits it)."""
    _check_coder(sorter, coder)
    dev = resolve(device)
    n = block.shape[0]
    if filter_mode == "auto" and _segments is None:
        _segments = detect_segments_gated(block)
    if _segments is not None and len(_segments) > 1:
        subs = []
        start = 0
        for sl in _segments:
            subs.append(compress_block(
                block[start: start + sl], block_cap, use_lzp, sorter,
                filter_mode, coder, _segments=[sl], device=dev))
            start += sl
        head = _HEAD.pack(n, 0, 0, 0, len(subs), 0, CODER_SEGMENTED)
        return head + np.asarray(
            [len(s) for s in subs], "<u4").tobytes() + b"".join(subs)
    cap = _cap_for(block_cap)
    flags = 0
    orig_block = block
    fb = _filter_byte_for(block, filter_mode)
    if fb != FILTER_NONE:
        block = apply_filter_np(block, fb)
        flags |= FLAG_FILTER
    stage = block
    if use_lzp:
        with timing.stage("bsc.lzp"):
            lz = lzp_encode(block)
        if lz is not None:
            stage = np.frombuffer(lz, np.uint8)
            flags |= FLAG_LZP
    m_lzp = stage.shape[0]
    padded = np.zeros(_tcap_for(m_lzp, cap), np.uint8)
    padded[:m_lzp] = stage
    with timing.stage("bsc.transform"):
        ranks, idx0, anchors, a_ok = forward_ranks_anchored(
            torch.from_numpy(padded).to(dev), m_lzp, ANCHOR_STRIDE)
    return _finish_block_grc(ranks, idx0, anchors, a_ok, orig_block, n,
                             m_lzp, cap, flags, fb)


def compress(data: bytes | np.ndarray, block_size: int = DEFAULT_BLOCK,
             use_lzp: bool = True, sorter: str = "bwt",
             filter_mode: str = "auto", coder: int = CODER_RANS,
             device: str | None = None) -> bytes:
    """bytes -> bsc container, tpulc's signature and defaults; each
    block transformed and coded on `device` (default "cuda").  Only
    coder 2 (`-e2`) on the BWT sorter is ported: the default coder 1
    raises NotImplementedError."""
    _check_coder(sorter, coder)
    if coder != CODER_ABC:
        # tpulc's compress sends every other coder value down its
        # coder-1 batched path
        raise NotImplementedError(
            f"bsc coder {coder} is not ported to tpulc_torch yet: {_E1}")
    dev = resolve(device)
    arr = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.asarray(data, np.uint8)
    starts = range(0, max(arr.shape[0], 1), block_size)
    blocks = [arr[s: s + block_size] for s in starts]
    segs = [detect_segments_gated(b) if filter_mode == "auto" else None
            for b in blocks]
    payloads = [compress_block(b, block_size, use_lzp, sorter, filter_mode,
                               coder, _segments=sl, device=dev)
                for b, sl in zip(blocks, segs)]
    c = Container(
        codec_id=CODEC_BSC, flags=0, orig_len=arr.shape[0],
        block_size=block_size, comp_sizes=[len(p) for p in payloads],
        payloads=payloads, data_adler=adler32_np(arr),
    )
    return c.to_bytes()


# ---------------------------------------------------------- decompress

def grc_block_args(payload: bytes, block_cap: int, dev: torch.device):
    """Parse and validate one group-rank payload; put K6's inputs on
    `dev`.  Returns ((filter byte, anchors or None, transform capacity
    dcap), K6's arguments: `grc_decode_walk(*args)` gives the ranks as
    int32[dcap // GCHUNK, GCHUNK])."""
    _, m_lzp, m, idx0, nwords, flags, _ = _HEAD.unpack(payload[: _HEAD.size])
    off = _HEAD.size
    filt = FILTER_NONE
    if flags & FLAG_FILTER:
        filt = payload[off]
        off += 1
    cap = _cap_for(block_cap)
    anchors = None
    if flags & FLAG_ANCHORS:
        r_used = max(1, -(-m_lzp // ANCHOR_STRIDE))
        aw = max(1, int(cap - 1).bit_length())
        nb = -(-r_used * aw // 8)
        anchors = unpack_fields_np(payload[off: off + nb], aw, r_used)
        off += nb
    dcap = _tcap_for(max(m, m_lzp), cap)
    inits, off = G.unpack_inits(payload, off)
    cinits = np.frombuffer(payload[off: off + 2 * G.NFAM], "<u2")
    off += 2 * G.NFAM
    maxbits, nlanes = struct.unpack("<II", payload[off: off + 8])
    off += 8
    # hostile-field bounds (tpulc `:717-724`): a lane cannot carry more
    # events than MAX_GROUP_BITS per symbol, and the lane count is fixed
    # by the block geometry.  The port adds the bounds its gathers need:
    # the stage fits the transform, idx0 and the anchors are its rows.
    lcap_g = max(1, dcap // G.GCHUNK)
    bound = G.MAX_GROUP_BITS * G.GCHUNK
    rows = max(m_lzp, 1)
    if (nlanes > lcap_g or maxbits > bound or m_lzp > dcap or idx0 >= rows
            or (anchors is not None and int(anchors.max()) >= rows)):
        raise ValueError("bad grc payload geometry")
    counts = np.frombuffer(payload[off: off + 2 * nlanes], "<u2").astype(
        np.int32)
    off += 2 * nlanes
    states = np.frombuffer(payload[off: off + 4 * nlanes], "<u4")
    off += 4 * nlanes
    flat = np.frombuffer(payload[off: off + 2 * nwords], "<u2")
    if int(counts.max(initial=0)) > bound:
        raise ValueError("bad grc payload geometry")
    Wc = G.bucket_bits(int(counts.max(initial=0)) + 2, lo=64)
    words_p = np.zeros((lcap_g, Wc), np.uint16)
    lane_valid = np.arange(Wc)[None, :] < counts[:, None]
    words_p[:nlanes][lane_valid] = flat
    states_p = np.full(lcap_g, 1 << 16, np.uint32)
    states_p[:nlanes] = states
    args = (torch.from_numpy(words_p.view(np.int16)).to(dev),
            torch.from_numpy(states_p.view(np.int32)).to(dev),
            torch.from_numpy(inits.astype(np.int32)).to(dev),
            torch.from_numpy(cinits.astype(np.int32)).to(dev), m_lzp,
            maxbits, G.GCHUNK)
    return (filt, anchors, dcap), args


def decompress_block(payload: bytes, block_cap: int,
                     device: str | None = None, _depth: int = 0):
    """One payload -> uint8 block."""
    dev = resolve(device)
    (n, m_lzp, m, idx0, nwords, flags,
     coder) = _HEAD.unpack(payload[: _HEAD.size])
    off = _HEAD.size
    if flags & FLAG_STORED:
        return np.frombuffer(payload[off: off + n], np.uint8)
    if coder == CODER_SEGMENTED:
        # compress never nests segments; a crafted chain of single-
        # segment payloads must raise a stream error, not recurse
        if _depth >= 1:
            raise ValueError("bad segmented payload: nested segments")
        nseg = nwords
        if nseg < 1 or nseg > 4096 or off + 4 * nseg > len(payload):
            raise ValueError("bad segmented payload")
        sizes = np.frombuffer(payload[off: off + 4 * nseg], "<u4")
        off += 4 * nseg
        if int(sizes.sum()) != len(payload) - off:
            raise ValueError("bad segmented payload sizes")
        parts = []
        for sz in sizes:
            parts.append(decompress_block(payload[off: off + int(sz)],
                                          block_cap, dev, _depth + 1))
            off += int(sz)
        return np.concatenate(parts)
    if flags & SORTER_MASK:
        raise NotImplementedError(
            f"bsc ST-sorted payloads are not ported to tpulc_torch yet: {_ST}")
    if coder == CODER_RANS:
        raise NotImplementedError(
            f"bsc coder-1 payloads are not ported to tpulc_torch yet: {_E1}")
    if coder != CODER_GRC:
        raise NotImplementedError(
            f"bsc coder-{coder} payloads are not ported to tpulc_torch yet: "
            f"{_ST}")
    with timing.stage("bsc.rans.decode"):
        (filt, anchors, dcap), args = grc_block_args(payload, block_cap, dev)
        ranks = grc_decode_walk(*args).reshape(dcap)
    with timing.stage("bsc.inverse"):
        if anchors is not None:
            anch_p = np.full(-(-dcap // ANCHOR_STRIDE), idx0, np.int32)
            anch_p[: anchors.shape[0]] = anchors
            stage = inverse_ranks_anchored(
                ranks, m_lzp, torch.from_numpy(anch_p).to(dev),
                ANCHOR_STRIDE)
        else:
            stage = inverse_ranks(ranks, m_lzp, idx0)
        stage = stage[:m_lzp].cpu().numpy()
    if flags & FLAG_LZP:
        with timing.stage("bsc.lzp.decode"):
            out = np.frombuffer(lzp_decode(stage, n), np.uint8)
    else:
        out = stage[:n]
    return invert_filter_np(out, filt)


def decompress(buf: bytes, device: str | None = None) -> bytes:
    """bsc container -> bytes, every block decoded on `device` (default
    "cuda"; raises when CUDA is absent)."""
    dev = resolve(device)
    c = Container.from_bytes(buf)
    if c.codec_id != CODEC_BSC:
        raise ValueError(f"not a bsc container (codec {c.codec_id})")
    parts = [decompress_block(p, c.block_size, dev) for p in c.payloads]
    out = b"".join(x.tobytes() for x in parts)[: c.orig_len]
    if not c.verify_data(np.frombuffer(out, np.uint8)):
        raise ValueError("data checksum mismatch after decompress")
    return out

"""bsc-class large-block codec (port of
`tpulc/codecs/bsclike/driver.py`; the same container and payload
bytes).

Compress: the entropy-model segmentation gate, the filter choice, host
LZP (`gold/lzp.c`), a block sorter on the block's device, then one of
three coders, or the stored fallback when coding does not shrink the
block.  Sorters (libbsc's `-m`): the masked BWT with anchors
(`bwt/masked.py`, the default), or ST-k for k = 3..8 (`bwt/stk.py`, one
stable sort), or `st8w`, ST-8 with the next-char stream F coded after
the last column so that the inverse runs on the device.  MTF runs K1,
the start tables and K2 on either.  Coders (libbsc's `-e`):
- coder 1 (`-e1`, the default): RLE2, order-2 context statistics and
  the static context rANS (`rans.py`);
- coder 2 (`-e2`): on the BWT, the group-rank coder (`grc.py`: K5 and
  the emission; payload coder byte 4); on an ST sorter, the adaptive
  binary coder over the RLE2 symbols (`rans_adaptive.py`, its walks in
  `csrc/abc.cu`; coder byte 2).
Blocks that no segmentation splits are batched as tpulc batches them,
except the group-rank coder and `st8w`, which go block by block: LZP in
two worker threads, every block transformed at one common capacity,
one pull of the small outputs, one encode of all blocks' lanes, one
compaction of the words.
Decompress: coder-1 blocks in one batched decode of all their lanes,
adaptive-coder blocks in another; then RLE2 decode and MTF decode (K4)
and the sorter's inverse: the anchored masked inverse BWT (or pointer
doubling for anchor-less blocks); for ST-k the context keys on the
device and the serial walk on the host (`gold/st_inverse.c`); for
`st8w` the predecessor permutation and pointer doubling on the device.
Group-rank blocks go through K6, MTF decode and the inverse BWT; then
LZP decode and the inverse filter on the host.

Per-block payload (little-endian), as tpulc writes it:

    n           u32   raw bytes in this block
    m_lzp       u32   LZP-stage bytes (== n when LZP was skipped)
    m           u32   RLE2 symbol count (coder 1); == m_lzp (coder 4)
    idx0        u32   BWT primary index
    nwords      u32   total rANS u16 words (segment count when segmented)
    flags       u8    bit0 LZP applied; bit1 stored raw; bit2 order-2
                      context model (always set by coder 1); bit3
                      anchors; bits4-6 sorter (0 = BWT, k-2 = ST-k, 7 =
                      st8w); bit7 filter byte
    coder       u8    1 = static context rANS, 2 = adaptive binary
                      rANS, 4 = group-rank coder, 3 = segmented wrapper
    [filter     u8    when flags bit7]
    [anchors    ceil(log2(cap))-bit-packed, ceil(m_lzp/1024)   when bit3]
  coder 1:
    freqs       u32 mask of the contexts present, then for each present
                context a 33-byte bitmap of its symbols + u16 per symbol
    nlanes      u32
    first_ctx   5-bit-packed context id entering each lane
  coder 2:
    inits       NMODELS * u16  initial model probabilities
    maxbits     u32   deepest lane's bit count (decode loop bound)
    nlanes      u32
    lane_cls    5-bit-packed context classes entering each lane
  coder 4:
    inits       NM-bit bitmap of used models + u16 per used model
    cinits      u16 * NFAM
    maxbits     u32   deepest lane's event count (decode loop bound)
    nlanes      u32
  all three:
    counts      u16 * nlanes   per-lane word counts
    states      u32 * nlanes   final rANS states
    words       u16 * nwords   per-lane streams back to back
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from functools import partial

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
from tpulc_torch.codecs.bsclike.rans_adaptive import (
    ACHUNK,
    MAX_SYM_BITS,
    NMODELS,
    abc_decode,
    abc_encode,
    abc_stats,
    bucket_bits,
    quantize_inits,
)
from tpulc_torch.codecs.bsclike.rans import (
    CHUNK,
    NCTX,
    PROB_SCALE,
    compact_words,
    ctx_of_stream,
    expand_words,
    normalize_freqs_ctx,
    rans_decode_ctx_batch,
    rans_encode_ctx_batch,
    slot_table,
)
from tpulc_torch.codecs.bwt.masked import (
    forward_masked_anchored,
    forward_ranks_anchored,
    inverse_masked,
    inverse_masked_anchored,
    inverse_ranks,
    inverse_ranks_anchored,
)
from tpulc_torch.codecs.bwt.rle import ALPHABET, rle2_decode, rle2_encode
from tpulc_torch.codecs.bwt.stk import (
    st_decode,
    st_decode_device_masked,
    st_encode_masked,
    st_encode_with_next_masked,
)
from tpulc_torch.device import resolve
from tpulc_torch.gold.lzp import lzp_decode, lzp_encode
from tpulc_torch.pipeline.container import Container
from tpulc_torch.pipeline.registry import CODEC_BSC
from tpulc_torch.primitives.bits import pack_fields_np, unpack_fields_np
from tpulc_torch.primitives.checksum import adler32_np
from tpulc_torch.primitives.mtf import mtf_decode, mtf_encode
from tpulc_torch.utils import timing

DEFAULT_BLOCK = 25 * 1024 * 1024
ANCHOR_STRIDE = 1024  # bsc blocks are large; halve anchor count

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
FLAG_CTX = 4
FLAG_ANCHORS = 8
# bits 4-6: the sorter (libbsc's `-m`), 0 = BWT, k-2 = ST-k (k = 3..8),
# 7 = st8w (ST-8 with the wired next-char stream)
SORTER_SHIFT = 4
SORTER_MASK = 0x7 << SORTER_SHIFT
FLAG_FILTER = 0x80
FCTX_BITS = 5  # context ids < NCTX = 32; adaptive lane classes < 32 too


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


def _sorter_k(name: str) -> tuple[int, bool]:
    """'bwt' -> (0, False); 'st3'..'st8' -> (k, False); 'st8w' -> (8,
    True); anything else raises ValueError."""
    if name == "bwt":
        return 0, False
    if name == "st8w":
        return 8, True
    if name.startswith("st") and name[2:] in ("3", "4", "5", "6", "7", "8"):
        return int(name[2:]), False
    raise ValueError(f"unknown sorter {name!r} (bwt, st3..st8, st8w)")


def _sorter_flag_bits(k_sort: int, wired: bool = False) -> int:
    if wired:
        return 7 << SORTER_SHIFT
    return ((k_sort - 2) << SORTER_SHIFT) if k_sort else 0


def _sorter_k_of_flags(flags: int) -> tuple[int, bool]:
    c = (flags & SORTER_MASK) >> SORTER_SHIFT
    if c == 7:
        return 8, True
    return (c + 2, False) if c else (0, False)


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


def _dcap_of(m: int, m_lzp: int, flags: int, cap: int) -> int:
    """A payload's decode-side transform capacity (tpulc `:693-697`):
    wired ST streams code 2 * m_lzp bytes (last || F) at up to 2 * cap.
    Raises ValueError when its counts do not fit it."""
    if _sorter_k_of_flags(flags)[1]:
        need, top = max(m, 2 * m_lzp), 2 * cap
    else:
        need, top = max(m, m_lzp), cap
    dcap = _tcap_for(need, top)
    if need > dcap:
        raise ValueError(f"bad bsc payload geometry: {need} symbols over "
                         f"the capacity {dcap}")
    return dcap


def _check_coder(sorter: str, coder: int) -> None:
    _sorter_k(sorter)
    if coder not in (CODER_RANS, CODER_ABC, CODER_GRC):
        raise ValueError(f"unknown bsc coder {coder}")


def _cum_of(fq: np.ndarray) -> np.ndarray:
    """[R, S] quantised tables -> their exclusive cumulative sums."""
    return np.concatenate(
        [np.zeros((fq.shape[0], 1), np.int32),
         np.cumsum(fq, axis=1)[:, :-1].astype(np.int32)], axis=1)


def _pack_freq_tables(fq: np.ndarray) -> bytes:
    """[NCTX, ALPHABET] quantized freqs -> u32 context-presence mask,
    then per present context a 33-byte presence bitmap + u16 per present
    symbol.  A context whose table is the default (symbol 0 certain,
    what normalize_freqs gives a context never entered) ships as one
    clear mask bit; the decoder rebuilds the same table."""
    used = ~((fq[:, 0] == PROB_SCALE) & (fq[:, 1:].sum(axis=1) == 0))
    mask = int(sum(1 << k for k in np.flatnonzero(used)))
    parts = [struct.pack("<I", mask)]
    for k in np.flatnonzero(used):
        present = fq[k] > 0
        bits = np.zeros(264, np.uint8)
        bits[: ALPHABET] = present
        parts.append(np.packbits(bits).tobytes())
        parts.append(fq[k][present].astype("<u2").tobytes())
    return b"".join(parts)


def _unpack_freq_tables(buf: bytes, off: int):
    """Inverse of `_pack_freq_tables` -> (fq int32[NCTX, ALPHABET], the
    offset past them).  Raises ValueError on a truncated table or one
    that does not sum to PROB_SCALE (tpulc decodes those through
    clamped gathers)."""
    if off + 4 > len(buf):
        raise ValueError("bad coder-1 payload: truncated tables")
    (mask,) = struct.unpack("<I", buf[off: off + 4])
    off += 4
    fq = np.zeros((NCTX, ALPHABET), np.int32)
    for k in range(NCTX):
        if not (mask >> k) & 1:
            fq[k][0] = PROB_SCALE
            continue
        if off + 33 > len(buf):
            raise ValueError("bad coder-1 payload: truncated tables")
        bits = np.unpackbits(
            np.frombuffer(buf[off: off + 33], np.uint8))[:ALPHABET]
        off += 33
        nnz = int(bits.sum())
        if off + 2 * nnz > len(buf):
            raise ValueError("bad coder-1 payload: truncated tables")
        fq[k][bits.astype(bool)] = np.frombuffer(
            buf[off: off + 2 * nnz], "<u2")
        off += 2 * nnz
    if (fq.sum(axis=1) != PROB_SCALE).any():
        raise ValueError("bad coder-1 payload: a table does not sum to "
                         f"{PROB_SCALE}")
    return fq, off


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


def _ctx_stats(syms: torch.Tensor, m):
    """Order-2 statistics of the valid prefix -> (hists int64[NCTX,
    ALPHABET], per-position contexts int32[cap]); tpulc's sort and
    searchsorted histogram as a bincount of ctx * ALPHABET + sym."""
    ctx = ctx_of_stream(syms)
    valid = torch.arange(syms.shape[0], device=syms.device) < m
    key = torch.where(valid, ctx * ALPHABET + syms, NCTX * ALPHABET)
    # bincount reads its input's min and max back to size its bins
    hists = timing.wait(torch.bincount, key, None, NCTX * ALPHABET + 1,
                        syncs=2, nbytes=2 * key.element_size())
    return hists[: NCTX * ALPHABET].reshape(NCTX, ALPHABET), ctx


def _meta(m, idx0, ok, anchors, hists, ctx) -> torch.Tensor:
    """One block's small transform outputs in one int64 row: [m, idx0,
    ok, anchors (Rcap), hists (NCTX * ALPHABET), first contexts
    (lanes)]."""
    dev = hists.device
    return torch.cat([
        torch.stack([
            v.to(torch.int64) if isinstance(v, torch.Tensor)
            else timing.upload(torch.tensor(v, dtype=torch.int64), dev)
            for v in (m, idx0, ok)]),
        anchors.to(torch.int64), hists.reshape(-1),
        ctx.reshape(-1, CHUNK)[:, 0].to(torch.int64)])


def _fwd_packed(padded: torch.Tensor, n: int):
    """Masked BWT + anchors, MTF, RLE2 and statistics of one block ->
    (syms, ctx, meta); syms and ctx stay on the device for the batched
    coder."""
    syms, m, idx0, anchors, a_ok = forward_masked_anchored(
        padded, n, ANCHOR_STRIDE)
    with timing.stage("bsc.stats"):
        hists, ctx = _ctx_stats(syms, m)
        return syms, ctx, _meta(m, idx0, int(a_ok), anchors, hists, ctx)


def _rle_stats(last: torch.Tensor, n: int, idx0):
    """MTF (K1, the start tables, K2), RLE2 and statistics of a sorted
    stream whose first n bytes are real -> (syms, ctx, meta) with
    tpulc's meta layout, ok = 0 and zero anchor rows (an ST block has
    no anchors).  Pads are MTF rank 255, one literal symbol each."""
    cap = last.shape[0]
    idx = torch.arange(cap, device=last.device)
    ranks = torch.where(idx < n, mtf_encode(last), 255).to(torch.uint8)
    syms, m_all = rle2_encode(ranks)
    m = m_all - (cap - n)
    hists, ctx = _ctx_stats(syms, m)
    anchors = torch.zeros(-(-cap // ANCHOR_STRIDE), dtype=torch.int64,
                          device=last.device)
    return syms, ctx, _meta(m, idx0, 0, anchors, hists, ctx)


def _fwd_packed_st(padded: torch.Tensor, n: int, k: int):
    """ST-k twin of `_fwd_packed` (tpulc `:279-306`): one stable sort
    in place of the BWT's refinement rounds."""
    last, idx0 = st_encode_masked(padded, n, k)
    return _rle_stats(last, n, idx0)


def _fwd_packed_st_wired(padded: torch.Tensor, n: int, k: int):
    """Wired ST-k forward (tpulc `:309-342`): the combined stream
    last[:n] || F[:n], zero-padded to 2 * cap, rides the same MTF, RLE2
    and statistics, so that the inverse is a static permutation on the
    device (`stk.st_decode_device_masked`); it costs one more coded
    stream."""
    cap = padded.shape[0]
    last, fnext, idx0 = st_encode_with_next_masked(padded, n, k)
    combined = torch.zeros(2 * cap, dtype=torch.uint8, device=padded.device)
    combined[:n] = last[:n]
    combined[n: 2 * n] = fnext[:n]
    return _rle_stats(combined, 2 * n, idx0)


def _rans_payload(fq, used: int, counts_np, nwords: int, a_ok: bool,
                  r_used: int, aw: int, n: int, head: tuple, fb: int,
                  anchors_np, fctx_np, states_np, flat) -> bytes | None:
    """Coder-1 payload of one block, or None when it would not be
    smaller than the block (tpulc's `body_size` test; the caller
    stores the block raw)."""
    body_size = _HEAD.size + 33 * NCTX + 2 * int((fq > 0).sum()) + 4 \
        + 6 * used + -(-used * FCTX_BITS // 8) + 2 * nwords \
        + (-(-r_used * aw // 8) if a_ok else 0)
    if body_size >= n:
        return None
    m_lzp, m, idx0, flags = head
    flags |= FLAG_CTX | (FLAG_ANCHORS if a_ok else 0)
    payload = _HEAD.pack(n, m_lzp, m, idx0, nwords, flags, CODER_RANS)
    if flags & FLAG_FILTER:
        payload += bytes([fb])
    if a_ok:
        payload += pack_fields_np(anchors_np[:r_used], aw)
    payload += _pack_freq_tables(fq)
    payload += struct.pack("<I", used)
    payload += pack_fields_np(fctx_np[:used], FCTX_BITS)
    payload += counts_np.astype("<u2").tobytes()
    payload += states_np.astype("<u4").tobytes()
    payload += flat.tobytes()
    return payload


def _pull_words(words, counts, states):
    """One coder's lanes -> host (counts int64[L], states int64[L],
    words uint16, all lanes' streams back to back)."""
    small = timing.wait(torch.Tensor.cpu, torch.cat([counts, states])).numpy()
    flat = timing.wait(torch.Tensor.cpu,
                       compact_words(words, counts)).numpy().view("<u2")
    return small[: counts.shape[0]], small[counts.shape[0]:], flat


def _encode_rans(syms2, gctx2, ms, fqs: np.ndarray, dev):
    """One batched encode of every block's lanes -> `_pull_words`."""
    B = fqs.shape[0]
    fq = fqs.reshape(B * NCTX, ALPHABET)
    return _pull_words(*rans_encode_ctx_batch(
        syms2, gctx2, ms, timing.upload(fq, dev),
        timing.upload(_cum_of(fq), dev)))


def _stored(block: np.ndarray, coder: int) -> bytes:
    n = block.shape[0]
    return _HEAD.pack(n, n, 0, 0, 0, FLAG_STORED, coder) + block.tobytes()


def compress_block(block: np.ndarray, block_cap: int, use_lzp: bool = True,
                   sorter: str = "bwt", filter_mode: str = "auto",
                   coder: int = CODER_RANS, _segments=None,
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
    if coder == CODER_RANS or (coder == CODER_ABC and _sorter_k(sorter)[0]):
        return _compress_batched([block], block_cap, use_lzp, filter_mode,
                                 dev, sorter, coder)[0]
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


def _compress_batched(blocks: list[np.ndarray], block_cap: int,
                      use_lzp: bool, filter_mode: str, dev: torch.device,
                      sorter: str = "bwt",
                      coder: int = CODER_RANS) -> list[bytes]:
    """Coder 1 on any sorter, or the adaptive coder on an ST sorter ->
    one payload a block: tpulc's batched path (`:969-1173`).  With one
    block it writes the bytes of the tail of tpulc's `compress_block`
    (`:576-654` for coder 1, `_finish_block_abc` for the adaptive
    coder), and so serves every st8w block.  LZP runs in two worker
    threads before the first dispatch, so that one transform capacity,
    from the largest LZP output, covers every block."""
    cap = _cap_for(block_cap)
    aw = max(1, int(cap - 1).bit_length())
    k_sort, wired = _sorter_k(sorter)
    sorter_bits = _sorter_flag_bits(k_sort, wired)

    def _lzp_one(orig):
        fbb = _filter_byte_for(orig, filter_mode)
        blk = apply_filter_np(orig, fbb) if fbb != FILTER_NONE else orig
        return orig, blk, fbb, (lzp_encode(blk) if use_lzp else None)

    with timing.stage("bsc.lzp"):
        with ThreadPoolExecutor(max_workers=2) as pool:
            lzp_results = list(pool.map(_lzp_one, blocks))
    stages, flags_l, fbs = [], [], []
    for orig, blk, fbb, lz in lzp_results:
        flags = sorter_bits | (FLAG_FILTER if fbb != FILTER_NONE else 0)
        stage = blk
        if lz is not None:
            stage = np.frombuffer(lz, np.uint8)
            flags |= FLAG_LZP
        stages.append((orig, stage))
        flags_l.append(flags)
        fbs.append(fbb)
    tcap = _tcap_for(max(st.shape[0] for _, st in stages), cap)
    # the coded stream's capacity: last || F for st8w
    scap = 2 * tcap if wired else tcap
    r_cap = -(-scap // ANCHOR_STRIDE)
    fwd = (partial(_fwd_packed_st_wired, k=k_sort) if wired
           else partial(_fwd_packed_st, k=k_sort) if k_sort else _fwd_packed)
    with timing.stage("bsc.transform"):
        devs = []
        for b, (_, stage) in enumerate(stages):
            timing.next_block(b)
            with timing.stage("bsc.block"):
                with timing.stage("bsc.upload"):
                    padded = np.zeros(tcap, np.uint8)
                    padded[: stage.shape[0]] = stage
                    block_t = timing.upload(padded, dev)
                devs.append(fwd(block_t, stage.shape[0]))
        with timing.stage("bsc.meta"):  # one pull
            metas = timing.wait(torch.Tensor.cpu,
                                torch.stack([d[2] for d in devs])).numpy()
    ms = metas[:, 0]
    heads = [(st.shape[0], int(ms[b]), int(metas[b, 1]), flags_l[b])
             for b, (_, st) in enumerate(stages)]
    oks = metas[:, 2].astype(bool)
    anchors = metas[:, 3: 3 + r_cap]
    syms2 = torch.stack([d[0] for d in devs])
    if coder == CODER_ABC:
        del devs
        return _finish_blocks_abc(syms2, ms, stages, heads, fbs, oks,
                                  anchors, aw, dev)
    with timing.stage("bsc.freqs"):
        hists = metas[:, 3 + r_cap: 3 + r_cap + NCTX * ALPHABET].reshape(
            -1, NCTX, ALPHABET)
        fqs = np.stack([normalize_freqs_ctx(h) for h in hists])
    lcap = max(1, scap // CHUNK)
    with timing.stage("bsc.rans"):
        offs = (torch.arange(len(blocks), device=dev) * NCTX)[:, None]
        counts_np, states_np, flat = _encode_rans(
            syms2, torch.stack([d[1] for d in devs]) + offs, ms, fqs, dev)
        del devs, syms2
    with timing.stage("bsc.payload"):
        lane_offs = np.concatenate([[0], np.cumsum(counts_np)])
        payloads = []
        for b, (orig, stage) in enumerate(stages):
            used = max(1, -(-int(ms[b]) // CHUNK))
            lane0 = b * lcap
            cnts = counts_np[lane0: lane0 + used]
            nwords = int(cnts.sum())
            payload = _rans_payload(
                fqs[b], used, cnts, nwords, bool(oks[b]),
                max(1, -(-stage.shape[0] // ANCHOR_STRIDE)), aw, orig.shape[0],
                heads[b], fbs[b], anchors[b],
                metas[b, 3 + r_cap + NCTX * ALPHABET:],
                states_np[lane0: lane0 + used],
                flat[lane_offs[lane0]: lane_offs[lane0] + nwords])
            # tpulc stores with the `coder` argument here (`:1140`), which
            # is CODER_RANS on every call that reaches this path
            payloads.append(payload if payload is not None
                            else _stored(orig, CODER_RANS))
    return payloads


def _finish_blocks_abc(syms2, ms, stages, heads, fbs, oks, anchors, aw,
                       dev) -> list[bytes]:
    """The adaptive coder over B blocks' RLE2 symbols int32[B, scap] ->
    one payload a block (tpulc's batched branch, `:1023-1131`; with one
    block it makes `_finish_block_abc`'s bytes, `:471-521`): the
    statistics, one pull of them, each block's initial probabilities
    on the host, one encode of every lane, one pull of the words."""
    B = syms2.shape[0]
    lcap = syms2.shape[1] // ACHUNK
    with timing.stage("bsc.rans"):
        ones, tot, lane_bits, lane_cls = abc_stats(syms2, ms)
        stats = torch.cat([ones.reshape(-1), tot.reshape(-1), lane_bits,
                           lane_cls]).cpu().numpy()
        nm = B * NMODELS
        inits = quantize_inits(stats[:nm].reshape(B, NMODELS),
                               stats[nm: 2 * nm].reshape(B, NMODELS))
        lane_bits = stats[2 * nm: 2 * nm + B * lcap].reshape(B, lcap)
        lane_cls = stats[2 * nm + B * lcap:]
        W = bucket_bits(max(int(lane_bits.max()), 1))
        counts_np, states_np, flat = _pull_words(*abc_encode(
            syms2, ms, torch.from_numpy(inits.astype(np.int32)).to(dev), W))
    lane_offs = np.concatenate([[0], np.cumsum(counts_np)])
    payloads = []
    for b, (orig, stage) in enumerate(stages):
        n = orig.shape[0]
        m_lzp, m, idx0, flags = heads[b]
        used = max(1, -(-m // ACHUNK))
        lane0 = b * lcap
        cnts = counts_np[lane0: lane0 + used]
        nwords = int(cnts.sum())
        r_used = max(1, -(-m_lzp // ANCHOR_STRIDE))
        body_size = _HEAD.size + 2 * NMODELS + 8 + 6 * used \
            + -(-used * FCTX_BITS // 8) + 2 * nwords \
            + (-(-r_used * aw // 8) if oks[b] else 0)
        if body_size >= n:
            payloads.append(_stored(orig, CODER_ABC))
            continue
        flags |= FLAG_ANCHORS if oks[b] else 0
        payload = _HEAD.pack(n, m_lzp, m, idx0, nwords, flags, CODER_ABC)
        if flags & FLAG_FILTER:
            payload += bytes([fbs[b]])
        if oks[b]:
            payload += pack_fields_np(anchors[b, :r_used], aw)
        payload += inits[b].astype("<u2").tobytes()
        payload += struct.pack("<II", int(lane_bits[b].max()), used)
        payload += pack_fields_np(lane_cls[lane0: lane0 + used], FCTX_BITS)
        payload += cnts.astype("<u2").tobytes()
        payload += states_np[lane0: lane0 + used].astype("<u4").tobytes()
        payload += flat[lane_offs[lane0]: lane_offs[lane0] + nwords] \
            .tobytes()
        payloads.append(payload)
    return payloads


def compress(data: bytes | np.ndarray, block_size: int = DEFAULT_BLOCK,
             use_lzp: bool = True, sorter: str = "bwt",
             filter_mode: str = "auto", coder: int = CODER_RANS,
             device: str | None = None) -> bytes:
    """bytes -> bsc container, tpulc's signature and defaults; each
    block transformed and coded on `device` (default "cuda").  sorter
    "bwt", "st3".."st8" or "st8w"; coder 1 (the default) or 2; tpulc
    sends any other coder down its coder-1 path, the port raises
    ValueError."""
    _check_coder(sorter, coder)
    if coder not in (CODER_RANS, CODER_ABC):
        raise ValueError(f"bsc compress takes coder 1 or 2, not {coder}")
    k_sort, wired = _sorter_k(sorter)
    with timing.stage("bsc.compress"):
        dev = resolve(device)
        arr = np.frombuffer(data, np.uint8) \
            if isinstance(data, (bytes, bytearray)) \
            else np.asarray(data, np.uint8)
        starts = range(0, max(arr.shape[0], 1), block_size)
        blocks = [arr[s: s + block_size] for s in starts]
        with timing.stage("bsc.detect"):
            segs = [detect_segments_gated(b) if filter_mode == "auto"
                    else None for b in blocks]
        if any(sl is not None and len(sl) > 1 for sl in segs) or wired \
                or (coder == CODER_ABC and not k_sort):
            # a segmented input, st8w or the group-rank coder: block by
            # block
            payloads = []
            for i, (b, sl) in enumerate(zip(blocks, segs)):
                timing.next_block(i)
                with timing.stage("bsc.block"):
                    payloads.append(compress_block(
                        b, block_size, use_lzp, sorter, filter_mode, coder,
                        _segments=sl, device=dev))
        else:
            payloads = _compress_batched(blocks, block_size, use_lzp,
                                         filter_mode, dev, sorter, coder)
        with timing.stage("bsc.adler32"):
            adler = adler32_np(arr)
        with timing.stage("bsc.container"):
            return Container(
                codec_id=CODEC_BSC, flags=0, orig_len=arr.shape[0],
                block_size=block_size, comp_sizes=[len(p) for p in payloads],
                payloads=payloads, data_adler=adler,
            ).to_bytes()


# ---------------------------------------------------------- decompress

def _parse_head(payload: bytes, block_cap: int):
    """The fields every coded payload opens with -> (head tuple (n,
    m_lzp, m, idx0, nwords, flags, coder), filter byte, anchors or None,
    the offset past them, the container's capacity)."""
    head = _HEAD.unpack(payload[: _HEAD.size])
    m_lzp, flags = head[1], head[5]
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
    return head, filt, anchors, off, cap


def _bad_rows(idx0: int, anchors, m_lzp: int) -> bool:
    """idx0 or an anchor is not a row of the m_lzp-byte stage."""
    rows = max(m_lzp, 1)
    return idx0 >= rows or (anchors is not None
                            and int(anchors.max()) >= rows)


def grc_block_args(payload: bytes, block_cap: int, dev: torch.device):
    """Parse and validate one group-rank payload; put K6's inputs on
    `dev`.  Returns ((filter byte, anchors or None, transform capacity
    dcap), K6's arguments: `grc_decode_walk(*args)` gives the ranks as
    int32[dcap // GCHUNK, GCHUNK])."""
    (_, m_lzp, m, idx0, nwords, _, _), filt, anchors, off, cap = \
        _parse_head(payload, block_cap)
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
    if (nlanes > lcap_g or maxbits > bound or m_lzp > dcap
            or _bad_rows(idx0, anchors, m_lzp)):
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


def rans_block_args(payload: bytes, block_cap: int) -> tuple:
    """Parse and validate one coder-1 payload -> (n, m_lzp, m, idx0,
    flags, filter byte, anchors or None, fq int32[NCTX, ALPHABET], fctx,
    counts, states, words uint16).  Raises ValueError where tpulc would
    assert (no FLAG_CTX) or decode through clamped gathers: more lanes
    than the transform holds, a lane count over CHUNK + 2, nwords other
    than the counts' sum or past the payload, m or m_lzp over the
    capacity, idx0 or an anchor not a row of the stage."""
    (n, m_lzp, m, idx0, nwords, flags, _), filt, anchors, off, cap = \
        _parse_head(payload, block_cap)
    if not flags & FLAG_CTX:
        raise ValueError("bad coder-1 payload: no FLAG_CTX (pre-context "
                         "bsc streams are not supported)")
    dcap = _dcap_of(m, m_lzp, flags, cap)
    fq, off = _unpack_freq_tables(payload, off)
    (nlanes,) = struct.unpack("<I", payload[off: off + 4])
    off += 4
    if nlanes > max(1, dcap // CHUNK) or _bad_rows(idx0, anchors, m_lzp):
        raise ValueError("bad coder-1 payload geometry")
    fb = -(-nlanes * FCTX_BITS // 8)
    fctx = unpack_fields_np(payload[off: off + fb], FCTX_BITS, nlanes)
    off += fb
    counts = np.frombuffer(payload[off: off + 2 * nlanes], "<u2").astype(
        np.int64)
    off += 2 * nlanes
    states = np.frombuffer(payload[off: off + 4 * nlanes], "<u4")
    off += 4 * nlanes
    if (int(counts.max(initial=0)) > CHUNK + 2 or int(counts.sum()) != nwords
            or off + 2 * nwords > len(payload)):
        raise ValueError("bad coder-1 payload lanes")
    flat = np.frombuffer(payload[off: off + 2 * nwords], "<u2")
    return (n, m_lzp, m, idx0, flags, filt, anchors, fq, fctx, counts,
            states, flat)


def abc_block_args(payload: bytes, block_cap: int) -> tuple:
    """Parse and validate one adaptive-coder payload -> (n, m_lzp, m,
    idx0, flags, filter byte, anchors or None, inits uint16[NMODELS],
    lane_cls, counts, states, words uint16, maxbits).  Raises ValueError
    where tpulc decodes through clamped gathers or reads past the
    payload: m or m_lzp over the capacity, more lanes than the transform
    holds, maxbits or a lane's word count over 16 bits a symbol, idx0 or
    an anchor not a row of the stage, truncated inits or lane fields,
    nwords other than the counts' sum or past the payload."""
    (n, m_lzp, m, idx0, nwords, flags, _), filt, anchors, off, cap = \
        _parse_head(payload, block_cap)
    dcap = _dcap_of(m, m_lzp, flags, cap)
    if off + 2 * NMODELS + 8 > len(payload):
        raise ValueError("bad abc payload: truncated inits")
    inits = np.frombuffer(payload[off: off + 2 * NMODELS], "<u2")
    off += 2 * NMODELS
    maxbits, nlanes = struct.unpack("<II", payload[off: off + 8])
    off += 8
    bound = MAX_SYM_BITS * ACHUNK
    if nlanes > max(1, dcap // ACHUNK) or maxbits > bound \
            or _bad_rows(idx0, anchors, m_lzp):
        raise ValueError("bad abc payload geometry")
    fb = -(-nlanes * FCTX_BITS // 8)
    if off + fb + 6 * nlanes > len(payload):
        raise ValueError("bad abc payload: truncated lanes")
    lane_cls = unpack_fields_np(payload[off: off + fb], FCTX_BITS, nlanes)
    off += fb
    counts = np.frombuffer(payload[off: off + 2 * nlanes], "<u2").astype(
        np.int64)
    off += 2 * nlanes
    states = np.frombuffer(payload[off: off + 4 * nlanes], "<u4")
    off += 4 * nlanes
    if (int(counts.max(initial=0)) > bound or int(counts.sum()) != nwords
            or off + 2 * nwords > len(payload)):
        raise ValueError("bad abc payload lanes")
    flat = np.frombuffer(payload[off: off + 2 * nwords], "<u2")
    return (n, m_lzp, m, idx0, flags, filt, anchors, inits, lane_cls,
            counts, states, flat, maxbits)


def _dcap_all(blocks: list[tuple], cap: int) -> int:
    """One batch's decode capacity: the largest of its blocks'."""
    return max(_dcap_of(b[2], b[1], b[4], cap) for b in blocks)


def _lane_rows(blocks: list[tuple], lcap: int):
    """The blocks' lane fields (counts, states and words, fields 9-11
    of `*_block_args`) block-major over lcap lanes a block -> (counts
    int64, states int64, the words back to back as int16); a lane past
    a block's own lanes gets no words and the state 2^16."""
    B = len(blocks)
    counts = np.zeros(B * lcap, np.int64)
    states = np.full(B * lcap, 1 << 16, np.int64)
    for j, b in enumerate(blocks):
        nl = b[9].shape[0]
        counts[j * lcap: j * lcap + nl] = b[9]
        states[j * lcap: j * lcap + nl] = b[10]
    flat = np.concatenate([b[11] for b in blocks]).view(np.int16)
    return counts, states, flat


def _syms_rans(blocks: list[tuple], dcap: int, dev) -> torch.Tensor:
    """tpulc's batched decode of coder-1 blocks (`:1251-1299`): one
    decode of every block's lanes at the batch's capacity; each lane
    past a block's own lanes gets state 2^16 and the block's first
    context -> syms int32[B, dcap]."""
    B = len(blocks)
    lcap = max(1, dcap // CHUNK)
    with timing.stage("bsc.lanes"):
        counts, states, flat = _lane_rows(blocks, lcap)
        fctx = np.repeat(np.arange(B, dtype=np.int64) * NCTX, lcap)
        fq = np.zeros((B * NCTX, ALPHABET), np.int32)
        for j, b in enumerate(blocks):
            fctx[j * lcap: j * lcap + b[8].shape[0]] += b[8]
            fq[j * NCTX: (j + 1) * NCTX] = b[7]
    with timing.stage("bsc.rans.decode"):
        freq_d = timing.upload(fq, dev)
        cum_d = timing.upload(_cum_of(fq), dev)
        counts_d = timing.upload(counts, dev)
        return rans_decode_ctx_batch(
            expand_words(timing.upload(flat, dev), counts_d),
            counts_d, timing.upload(states, dev),
            timing.upload(fctx, dev), [b[2] for b in blocks], freq_d,
            cum_d, slot_table(freq_d, cum_d), B)


def _syms_abc(blocks: list[tuple], dcap: int, dev) -> torch.Tensor:
    """tpulc's batched decode of adaptive-coder blocks (`:1300-1340`):
    one decode walk over every block's lanes, at most the deepest
    block's maxbits steps -> syms int32[B, dcap]."""
    B = len(blocks)
    lcap = max(1, dcap // ACHUNK)
    counts, states, flat = _lane_rows(blocks, lcap)
    cls = np.zeros(B * lcap, np.int32)
    for j, b in enumerate(blocks):
        cls[j * lcap: j * lcap + b[8].shape[0]] = b[8]
    inits = np.stack([b[7] for b in blocks]).astype(np.int32)
    with timing.stage("bsc.rans.decode"):
        width = bucket_bits(int(counts.max(initial=0)) + 2, lo=64)
        counts_d = torch.from_numpy(counts).to(dev)
        words = expand_words(torch.from_numpy(flat).to(dev), counts_d,
                             width - 2)
        return abc_decode(words, torch.from_numpy(states).to(dev),
                          torch.from_numpy(cls).to(dev),
                          [b[2] for b in blocks],
                          torch.from_numpy(inits).to(dev),
                          max(b[12] for b in blocks), B)


def _inverse(syms: torch.Tensor, blk: tuple, dev) -> np.ndarray:
    """One block's decoded symbols int32[dcap] -> its LZP-stage bytes
    uint8[m_lzp]: RLE2 decode and MTF decode (K4), then the sorter's
    inverse (tpulc `:841-858`, `:1341-1383`)."""
    _, m_lzp, m, idx0, flags, _, anchors = blk[:7]
    dcap = syms.shape[0]
    k_sort, wired = _sorter_k_of_flags(flags)
    with timing.stage("bsc.inverse"):
        if not k_sort:
            if anchors is None:
                stage = inverse_masked(syms, m, m_lzp, idx0)
            else:
                with timing.stage("bsc.upload"):
                    anch_p = np.full(-(-dcap // ANCHOR_STRIDE), idx0,
                                     np.int32)
                    anch_p[: anchors.shape[0]] = anchors
                    anch_t = timing.upload(anch_p, dev)
                stage = inverse_masked_anchored(syms, m, m_lzp, anch_t,
                                                ANCHOR_STRIDE)
            with timing.stage("bsc.pull"):
                return timing.wait(torch.Tensor.cpu, stage[:m_lzp]).numpy()
        last = mtf_decode(rle2_decode(syms, m)[0])
    with timing.stage("bsc.unsort"):
        if not wired:
            return st_decode(last[:m_lzp], idx0, k_sort)
        # last || F: F[i] = combined[(i + m_lzp) mod dcap]
        half = torch.arange(dcap // 2, device=dev)
        stage = st_decode_device_masked(
            last[: dcap // 2], last[(half + m_lzp) % dcap], idx0, m_lzp,
            k_sort)
        return stage[:m_lzp].cpu().numpy()


def _decode_blocks(blocks: dict[int, tuple], cap: int, dev,
                   coder: int) -> list[np.ndarray]:
    """Coder-1 or adaptive-coder blocks (their `*_block_args`, by block
    index) -> each block's LZP-stage bytes: one batched decode, then
    each inverse."""
    rows = list(blocks.values())
    dcap = _dcap_all(rows, cap)
    syms2 = (_syms_rans if coder == CODER_RANS else _syms_abc)(
        rows, dcap, dev)
    stages = []
    for j, (i, b) in enumerate(blocks.items()):
        timing.next_block(i)
        with timing.stage("bsc.block"):
            stages.append(_inverse(syms2[j], b, dev))
    return stages


def _unstage(stage: np.ndarray, n: int, flags: int, filt: int) -> np.ndarray:
    """LZP decode (when applied) and the inverse filter on the host."""
    if flags & FLAG_LZP:
        with timing.stage("bsc.lzp.decode"):
            out = np.frombuffer(lzp_decode(stage, n), np.uint8)
    else:
        out = stage[:n]
    return invert_filter_np(out, filt)


_BLOCK_ARGS = {CODER_RANS: rans_block_args, CODER_ABC: abc_block_args}


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
    if coder in _BLOCK_ARGS:
        blk = _BLOCK_ARGS[coder](payload, block_cap)
        (stage,) = _decode_blocks({0: blk}, _cap_for(block_cap), dev, coder)
        return _unstage(stage, n, flags, blk[5])
    if coder != CODER_GRC:
        raise ValueError(f"bad bsc payload: unknown coder {coder}")
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
    return _unstage(stage, n, flags, filt)


def decompress(buf: bytes, device: str | None = None) -> bytes:
    """bsc container -> bytes, every block decoded on `device` (default
    "cuda"; raises when CUDA is absent).  Coder-1 blocks share one
    batched decode and adaptive-coder blocks another (tpulc's "block"
    and "ablock" batches); stored, segmented, group-rank and st8w
    payloads go block by block."""
    with timing.stage("bsc.decompress"):
        dev = resolve(device)
        with timing.stage("bsc.container"):
            c = Container.from_bytes(buf)
        if c.codec_id != CODEC_BSC:
            raise ValueError(f"not a bsc container (codec {c.codec_id})")
        batches = {CODER_RANS: {}, CODER_ABC: {}}
        with timing.stage("bsc.parse"):
            for i, p in enumerate(c.payloads):
                flags, coder = _HEAD.unpack(p[: _HEAD.size])[5:]
                if coder in batches and not flags & FLAG_STORED \
                        and not _sorter_k_of_flags(flags)[1]:
                    batches[coder][i] = _BLOCK_ARGS[coder](p, c.block_size)
        outs = {}
        for coder, batch in batches.items():
            if not batch:
                continue
            stages = _decode_blocks(batch, _cap_for(c.block_size), dev,
                                    coder)
            for (i, blk), stage in zip(batch.items(), stages):
                timing.next_block(i)
                with timing.stage("bsc.block"):
                    outs[i] = _unstage(stage, blk[0], blk[4], blk[5])
        parts = []
        for i, p in enumerate(c.payloads):
            if i not in outs:
                timing.next_block(i)
                with timing.stage("bsc.block"):
                    outs[i] = decompress_block(p, c.block_size, dev)
            parts.append(outs[i])
        with timing.stage("bsc.join"):
            out = b"".join(x.tobytes() for x in parts)[: c.orig_len]
        with timing.stage("bsc.adler32"):
            ok = c.verify_data(np.frombuffer(out, np.uint8))
        if not ok:
            raise ValueError("data checksum mismatch after decompress")
        return out

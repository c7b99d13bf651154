"""Huffman decode (port of `tpulc/codecs/huffman/decode.py`).

Self-synchronising decode, the gap-array scheme of CUHD
(`cuhd-icpp/src/cuhd_gpu_decoder.cu:16-420`) as tpulc reformulates it:
a codeword straddles a subsequence boundary by at most L-1 bits, so the
decoder state crossing a boundary is an entry offset in [0, L).
Decoding every subsequence from each of the L entries gives a map
f_i : [0, L) -> [0, L) and a symbol count per entry; map composition is
associative, so a scan yields each subsequence's true entry and output
offset, and one more pass writes the symbols.  tpulc runs
`lax.associative_scan` and `while_loop`s; here the scan is a log-step
Hillis-Steele scan with `torch.gather`, and each while loop a Python
loop that asks the device whether any lane is still active (one host
sync per step — this path has no kernel; it serves streams without
chunk offsets).

The aligned decoders read the container's per-chunk bit offsets:
`huffman_decode_aligned` / `huffman_decode_uniform` walk a flat 2^L LUT
in plain torch; the batched decoders of the codec (`*_batch`) decode a
whole block group at once:

  ranks     plain torch: canonical rank by threshold counts, two
            symbols per 25-bit window (tpulc's XLA-only path);
  v1        K7 (`decode_kernels.huffman_walk_v1`);
  buffered  K3 packed (`decode_kernels.huffman_walk`, the default);
  flat      K8 (`decode_kernels.huffman_walk_flat`).

Each returns uint8 [B, ccap*chunk_syms]: the decoded symbols, and past
each block's symbol count the symbol of rank 0 (callers trim).  tpulc
maps ranks to symbols with one-hot MXU contractions (`decode.py:400-411,
514-523, 588-604`); here it is a direct gather ``ss[b, rank]``.
"""

from __future__ import annotations

import torch

from tpulc_torch.codecs.huffman import decode_kernels as dk
from tpulc_torch.codecs.huffman.device_tables import canonical_decode_params
from tpulc_torch.primitives.bits import M32, peek_bits
from tpulc_torch.utils import timing

DEFAULT_SUB_BITS = 512  # 16 x 32-bit units per subsequence


def _words64(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.int64) & M32


def _decode_maps(words, total_bits: int, lut_len, max_len: int,
                 sub_bits: int, nsub: int):
    """Phase 1: per-subsequence entry->exit maps and symbol counts
    (int64[nsub, L] each)."""
    L = max_len
    dev = words.device
    sub_start = (torch.arange(nsub, device=dev) * sub_bits)[:, None]
    end = sub_start + sub_bits
    pos = sub_start + torch.arange(L, device=dev)[None, :]
    cnt = torch.zeros((nsub, L), dtype=torch.int64, device=dev)
    while True:
        active = (pos < end) & (pos < total_bits)
        if not timing.wait(bool, active.any()):
            break
        step = lut_len[peek_bits(words, pos, L)]
        # a zero-length LUT entry means a corrupt stream; advance one bit
        step = torch.where(step == 0, 1, step)
        pos = pos + torch.where(active, step, 0)
        cnt = cnt + active
    return torch.clamp(pos - end, 0, L - 1), cnt


def _compose_scan(next_map, count_map):
    """Inclusive scan of (entry->exit, entry->count) maps along axis 0,
    entries on the last axis (axes between are independent streams):
    combine(a, b) = (b.next[a.next], a.count + b.count[a.next])."""
    nxt, cnt = next_map, count_map
    d = 1
    while d < nxt.shape[0]:
        an, ac = nxt[:-d], cnt[:-d]
        bn, bc = nxt[d:], cnt[d:]
        nxt = torch.cat([nxt[:d], torch.gather(bn, -1, an)])
        cnt = torch.cat([cnt[:d], ac + torch.gather(bc, -1, an)])
        d *= 2
    return nxt, cnt


def huffman_decode(words: torch.Tensor, total_bits: int, n_out: int,
                   lut_sym: torch.Tensor, lut_len: torch.Tensor, max_len: int,
                   sub_bits: int = DEFAULT_SUB_BITS,
                   out_dtype: torch.dtype = torch.uint8):
    """Self-synchronising parallel decode (no partition metadata needed).

    Args:
      words: integer [W] MSB-first bitstream (uint32 values).
      total_bits: valid bit count.
      n_out: output capacity (>= true symbol count).
      lut_sym/lut_len: flat 2^max_len decode LUT.
      max_len: L.
      sub_bits: subsequence size in bits (multiple of 32).

    Returns:
      (out [n_out] of out_dtype, n_valid int) — n_valid is the number of
      symbols the stream holds.
    """
    w = _words64(words)
    dev = w.device
    W = w.shape[0]
    nsub = max(1, -(-(W * 32) // sub_bits))
    lut_len = lut_len.to(device=dev, dtype=torch.int64)
    next_map, count_map = _decode_maps(w, int(total_bits), lut_len, max_len,
                                       sub_bits, nsub)
    incl_next, incl_cnt = _compose_scan(next_map, count_map)
    # exclusive prefix applied to the stream-initial state (entry 0)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    entry = torch.cat([zero, incl_next[:-1, 0]])
    offset = torch.cat([zero, incl_cnt[:-1, 0]])
    n_valid = timing.wait(int, incl_cnt[-1, 0])
    sub_start = torch.arange(nsub, device=dev) * sub_bits
    ends = torch.clamp(sub_start + sub_bits, max=int(total_bits))
    out = _decode_write(w, sub_start + entry, ends, offset, n_out, lut_sym,
                        lut_len, max_len, out_dtype)
    return out, n_valid


def _decode_write(words, pos, ends, oidx, n_out: int, lut_sym, lut_len,
                  max_len: int, out_dtype):
    """Phase 4 (and the aligned decoders): each lane decodes from bit
    `pos` to `ends` with the flat LUT, writing its symbols from output
    index `oidx` on; symbols outside [0, n_out) are dropped."""
    dev = words.device
    lut_sym = lut_sym.to(device=dev, dtype=torch.int64)
    lut_len = lut_len.to(device=dev, dtype=torch.int64)
    out = torch.zeros(n_out + 1, dtype=out_dtype, device=dev)  # +1: drop slot
    while True:
        active = pos < ends
        if not timing.wait(bool, active.any()):
            break
        win = peek_bits(words, pos, max_len)
        step = lut_len[win]
        step = torch.where(step == 0, 1, step)
        tgt = torch.where(active & (oidx >= 0) & (oidx < n_out), oidx, n_out)
        out[tgt] = lut_sym[win].to(out_dtype)
        pos = pos + torch.where(active, step, 0)
        oidx = oidx + active
    return out[:n_out]


def huffman_decode_aligned(words: torch.Tensor, total_bits: int, n_out: int,
                           lut_sym: torch.Tensor, lut_len: torch.Tensor,
                           max_len: int, chunk_bit_offsets: torch.Tensor,
                           chunk_sym_offsets: torch.Tensor,
                           out_dtype: torch.dtype = torch.uint8):
    """Decode when the container carries per-chunk offsets: chunk i
    starts at bit `chunk_bit_offsets[i]` and output index
    `chunk_sym_offsets[i]`, and ends where chunk i+1 starts (the last at
    total_bits) — cudpp's `d_encodeOffset` scheme (`include/cudpp.h:327`),
    no synchronisation phase."""
    w = _words64(words)
    dev = w.device
    pos = chunk_bit_offsets.to(device=dev, dtype=torch.int64)
    ends = torch.cat([pos[1:], torch.tensor([int(total_bits)], device=dev)])
    return _decode_write(w, pos, ends,
                         chunk_sym_offsets.to(device=dev, dtype=torch.int64),
                         n_out, lut_sym, lut_len, max_len, out_dtype)


def huffman_decode_uniform(words: torch.Tensor, total_bits: int, n_out: int,
                           lut_sym: torch.Tensor, lut_len: torch.Tensor,
                           max_len: int, chunk_bit_offsets: torch.Tensor,
                           chunk_syms: int,
                           out_dtype: torch.dtype = torch.uint8):
    """`huffman_decode_aligned` for UNIFORM chunks: chunk i starts at
    output index i*chunk_syms."""
    nsub = chunk_bit_offsets.shape[0]
    if nsub * chunk_syms < n_out:
        raise ValueError("chunks do not cover n_out symbols")
    sym_offs = torch.arange(nsub, device=chunk_bit_offsets.device) * chunk_syms
    return huffman_decode_aligned(words, total_bits, n_out, lut_sym, lut_len,
                                  max_len, chunk_bit_offsets, sym_offs,
                                  out_dtype)


# --- batched canonical decode (the codec's throughput path) ---


def canonical_params_device(lengths: torch.Tensor, max_len: int):
    """lengths int[B, 256] -> (limit [B, L+1], sub [B, L+1], order
    [B, 256]) int64: largest code per length, rank adjustment per
    length, and symbols in canonical (length, symbol) order."""
    L = max_len
    lengths = lengths.to(torch.int64)
    lvals = torch.arange(L + 1, device=lengths.device)
    cnt = (lengths[:, :, None] == lvals).sum(dim=1)   # [B, L+1]
    firsts = [torch.zeros_like(cnt[:, 0]), torch.zeros_like(cnt[:, 0])]
    for l in range(1, L):
        firsts.append((firsts[l] + cnt[:, l]) << 1)
    first = torch.stack(firsts, dim=1)
    base = torch.cumsum(cnt, dim=1) - cnt - cnt[:, 0:1]
    limit = first + cnt - 1
    sub = base - first
    sym = torch.arange(256, device=lengths.device)[None, :]
    key = torch.where(lengths > 0, lengths * 256 + sym, (1 << 20) + sym)
    order = torch.argsort(key, dim=1)
    return limit, sub, order


def _rank_of_window(w12, limit, sub, max_len: int):
    """[B, S] L-bit windows -> (len, rank) via L broadcast compares."""
    L = max_len
    ln = torch.ones_like(w12)
    for l in range(1, L):
        ln = ln + ((w12 >> (L - l)) > limit[:, l:l + 1])
    ln = torch.clamp(ln, max=L)
    v = w12 >> (L - ln)
    adj = torch.gather(sub, 1, ln)
    return ln, torch.clamp(v + adj, 0, 255)


def huffman_decode_ranks_batch(words: torch.Tensor, total_bits: torch.Tensor,
                               lengths: torch.Tensor,
                               chunk_bit_offsets: torch.Tensor,
                               chunk_syms: int, max_len: int) -> torch.Tensor:
    """Aligned-chunk decode of a block batch in plain torch.

    words int32[B, W], total_bits int32[B], lengths int[B, 256],
    chunk_bit_offsets int32[B, ccap] -> uint8 [B, ccap*chunk_syms]."""
    if chunk_syms % 2 or max_len > 12:
        raise ValueError("the ranks decoder needs an even chunk_syms and "
                         "max_len <= 12 (two codes per 25-bit window)")
    B, ccap = chunk_bit_offsets.shape
    L = max_len
    limit, sub, order = canonical_params_device(lengths, max_len)
    pos = chunk_bit_offsets.to(torch.int64) & M32
    ends = torch.cat([pos[:, 1:], total_bits.to(torch.int64)[:, None]], 1)
    word = dk._stream_reader(words, pos.reshape(-1))
    cols = []
    for _ in range(chunk_syms // 2):
        a1 = pos < ends
        w25 = dk._window(word, pos.reshape(-1), 25).reshape(B, ccap)
        ln1, r1 = _rank_of_window(w25 >> (25 - L), limit, sub, L)
        pos2 = pos + torch.where(a1, ln1, 0)
        a2 = pos2 < ends
        w12b = (w25 >> (25 - L - ln1)) & ((1 << L) - 1)
        ln2, r2 = _rank_of_window(w12b, limit, sub, L)
        pos = pos2 + torch.where(a2, ln2, 0)
        cols += [torch.where(a1, r1, 0), torch.where(a2, r2, 0)]
    ranks = torch.stack(cols, dim=2).reshape(B, ccap * chunk_syms)
    return torch.gather(order, 1, ranks).to(torch.uint8)


def _ranks_to_symbols(ranks: torch.Tensor, ss: torch.Tensor, B: int):
    """ranks in [0, 256) [B*ccap, C] -> uint8 symbols [B, ccap*C]."""
    r = ranks.reshape(B, -1).to(torch.int64)
    return torch.gather(ss.to(torch.int64), 1, r).to(torch.uint8)


def walk_args(words, total_bits, lengths, chunk_bit_offsets, chunk_syms: int,
              max_len: int):
    """A parsed group -> (K3/K7 arguments, canonical symbol orders ss
    [B, 256]): one stream and one table per block."""
    B = words.shape[0]
    ccap = chunk_bit_offsets.shape[1]
    dev = words.device
    lim, base, ss = canonical_decode_params(lengths.to(dev), max_len)
    tab = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(
        ccap)
    return (words.contiguous(), total_bits.to(torch.int32).contiguous(),
            chunk_bit_offsets.to(torch.int32).reshape(-1).contiguous(),
            lim, base, tab, chunk_syms, max_len), ss


def flat_args(words, total_bits, lengths, chunk_bit_offsets, chunk_syms: int,
              max_len: int):
    """A parsed group -> (K8 arguments, ss [B, 256]).  Each block's chunk
    count is padded to a TILE multiple with empty chunks, so that a table
    tile never spans two blocks (tpulc `decode.py:564-573`)."""
    B = words.shape[0]
    ccap = chunk_bit_offsets.shape[1]
    dev = words.device
    L = max_len
    lim, base, ss = canonical_decode_params(lengths.to(dev), max_len)
    # left-justified limits: LJ[l] = lim[l] << (L-l) (nested regions)
    lj = lim << (L - torch.arange(L + 1, dtype=torch.int32, device=dev))
    ccap2 = -(-ccap // dk.TILE) * dk.TILE
    tb = total_bits.to(torch.int32)
    offs = torch.cat([chunk_bit_offsets.to(torch.int32),
                      tb[:, None].expand(B, ccap2 - ccap)], 1)
    left = torch.clamp(tb[:, None] - offs, max=chunk_syms * L)
    tiles = torch.arange(B, device=dev).repeat_interleave(ccap2 // dk.TILE)
    return (words.contiguous(), offs.reshape(-1), left.reshape(-1),
            lj[tiles].contiguous(), base[tiles].contiguous(), chunk_syms,
            max_len), ss


def huffman_decode_pallas_batch(words, total_bits, lengths,
                                chunk_bit_offsets, chunk_syms: int,
                                max_len: int) -> torch.Tensor:
    """The `v1` decode: K7 over the whole group -> uint8 [B, ccap*C]."""
    with timing.stage("huffman.tables"):
        args, ss = walk_args(words, total_bits, lengths, chunk_bit_offsets,
                             chunk_syms, max_len)
    with timing.stage("huffman.walk"):
        ci = dk.huffman_walk_v1(*args)
    with timing.stage("huffman.symbols"):
        return _ranks_to_symbols(ci.clamp(0, 255), ss, words.shape[0])


def huffman_decode_buffered_batch(words, total_bits, lengths,
                                  chunk_bit_offsets, chunk_syms: int,
                                  max_len: int) -> torch.Tensor:
    """The `buffered` decode (the default): K3 packed over the whole group
    -> uint8 [B, ccap*C]."""
    with timing.stage("huffman.tables"):
        args, ss = walk_args(words, total_bits, lengths, chunk_bit_offsets,
                             chunk_syms, max_len)
    with timing.stage("huffman.walk"):
        packed = dk.huffman_walk(*args, packed=True)
    with timing.stage("huffman.symbols"):
        return _ranks_to_symbols(packed.view(torch.uint8), ss,
                                 words.shape[0])


def huffman_decode_flat_batch(words, total_bits, lengths, chunk_bit_offsets,
                              chunk_syms: int, max_len: int) -> torch.Tensor:
    """The `flat` decode: K8 over the whole group -> uint8 [B, ccap*C]."""
    B = words.shape[0]
    ccap = chunk_bit_offsets.shape[1]
    with timing.stage("huffman.tables"):
        args, ss = flat_args(words, total_bits, lengths, chunk_bit_offsets,
                             chunk_syms, max_len)
    with timing.stage("huffman.walk"):
        packed = dk.huffman_walk_flat(*args)
    with timing.stage("huffman.symbols"):
        ranks = packed.view(torch.uint8).reshape(B, -1)
        return _ranks_to_symbols(ranks[:, : ccap * chunk_syms], ss, B)

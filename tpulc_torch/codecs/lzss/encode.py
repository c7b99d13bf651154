"""Parallel LZSS encoder emitting the Dipperstein 12/4 bitstream (port
of `tpulc/codecs/lzss/encode.py`; the same bits).

The reference's brute-force window scans (lzss-0.6.2 `brute.c:92`)
become sort-based candidate discovery, and its serial greedy parse a
path-doubling orbit:

  1. each position's 3-byte prefix is an exact 24-bit key; one stable
     sort of (key, position) groups equal 3-grams by position, so each
     position's K most recent same-prefix predecessors are its match
     candidates, with K/2 more from a 7-gram hash;
  2. match extension compares packed 4-byte words; window and cursor
     constraints clamp the length;
  3. the greedy parse is the orbit of position 0 under p -> p +
     token_len(p) (`primitives.parallel.orbit_flags`);
  4. tokens pack by prefix-sum bit offsets (`primitives.bits.pack_bits`)
     in the reference layout (flag, low-8/high-4 offset, len-3).

The virtual 4096-byte space-filled initial window (`lzencode.c:165`)
is a prefix of the padded buffer, so early matches against it work as
the reference's do.  tpulc's uint32 arithmetic runs in int64 masked to
32 bits, and its `lax.clz` of a word's XOR becomes a count of equal
leading bytes.
"""

from __future__ import annotations

import torch

from tpulc_torch.primitives.bits import M32, pack_bits
from tpulc_torch.primitives.parallel import orbit_flags
from tpulc_torch.utils import timing

WINDOW = 4096
MAX_CODED = 18
MAX_UNCODED = 2
_HASH = 0x9E3779B1


def _chain_candidates(key: torch.Tensor, k_cand: int) -> torch.Tensor:
    """The k most recent predecessors sharing `key` (-1 where fewer),
    int64 [n_total, k], via one stable sort."""
    n_total = key.shape[0]
    skey, spos = torch.sort(key, stable=True)
    idx = torch.arange(n_total, device=key.device)
    cands = []
    for d in range(1, k_cand + 1):
        prev_pos = torch.roll(spos, d)
        valid = (idx >= d) & (torch.roll(skey, d) == skey)
        cands.append(torch.where(valid, prev_pos, -1))
    out = torch.empty((n_total, k_cand), dtype=torch.int64, device=key.device)
    out[spos] = torch.stack(cands, dim=1)
    return out


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h, c < 2^32 without int64 overflow."""
    return ((h & 0xFFFF) * c + ((((h >> 16) * c) & 0xFFFF) << 16)) & M32


def _match_candidates(padded: torch.Tensor, k_cand: int) -> torch.Tensor:
    """Candidate sources per position: the k most recent exact-3-gram
    predecessors, then k/2 recent 7-gram-hash predecessors (every
    candidate is byte-verified, so hash collisions are harmless)."""
    n_total = padded.shape[0]
    p = padded.to(torch.int64)
    idx = torch.arange(n_total, device=p.device)
    key3 = (p << 16) | (torch.roll(p, -1) << 8) | torch.roll(p, -2)
    key3 = torch.where(idx < n_total - 2, key3, (1 << 24) + idx)
    c3 = _chain_candidates(key3, k_cand)
    h = torch.zeros_like(p)
    for j in range(7):
        h = _mul32(h, _HASH) ^ torch.roll(p, -j)
    key7 = torch.where(idx < n_total - 6, h >> 2, (1 << 30) + idx)
    c7 = _chain_candidates(key7, max(1, k_cand // 2))
    return torch.cat([c3, c7], dim=1)


def _extend(padded: torch.Tensor, cand: torch.Tensor, n: int):
    """Longest verified candidate per data position -> (len, src), the
    earliest candidate column winning ties.  Four bytes a packed word:
    the equal leading bytes of a word pair are those of their XOR."""
    p = padded.to(torch.int64)
    w4 = ((p << 24) | (torch.roll(p, -1) << 16) | (torch.roll(p, -2) << 8)
          | torch.roll(p, -3))
    wp = [w4[WINDOW + 4 * k: WINDOW + 4 * k + n] for k in range(5)]
    pos = torch.arange(n, device=p.device) + WINDOW
    best_len = torch.zeros(n, dtype=torch.int64, device=p.device)
    best_src = torch.zeros(n, dtype=torch.int64, device=p.device)
    for kk in range(cand.shape[1]):
        src = cand[WINDOW: WINDOW + n, kk]
        srcc = src.clamp(min=0)
        ln = torch.zeros_like(best_len)
        still = src >= 0
        for k in range(5):
            x = w4[srcc + 4 * k] ^ wp[k]
            mb = ((x < (1 << 24)).long() + (x < (1 << 16)).long()
                  + (x < (1 << 8)).long() + (x == 0).long())
            ln = ln + torch.where(still, mb, 0)
            still = still & (x == 0)
        ln = ln.clamp(max=MAX_CODED)
        # window constraint and no overlap with the cursor
        in_window = (src >= pos - WINDOW) & (src >= 0)
        ln = torch.where(in_window, torch.minimum(ln, pos - src), 0)
        ln = torch.minimum(ln, n - (pos - WINDOW))
        take = ln > best_len
        best_len = torch.where(take, ln, best_len)
        best_src = torch.where(take, src, best_src)
    return best_len, best_src


def _exact_best_match(padded: torch.Tensor, n: int):
    """Exact longest match (3..18) per data position, brute.c-parity
    lengths, by incremental l-gram ranks: one stable sort a length.

    For length l, positions sharing an l-gram form groups; within a
    group the d-th sort predecessor is the d-th most recent earlier
    occurrence, and since recency distances are distinct integers, the
    nearest source at distance >= l is among the first l predecessors.
    Dense group ranks seed the next length's key (rank*256 + next
    byte)."""
    n_total = padded.shape[0]
    dev = padded.device
    idx = torch.arange(n_total, device=dev)
    p = padded.to(torch.int64)
    key = (p << 16) | (torch.roll(p, -1) << 8) | torch.roll(p, -2)
    key = torch.where(idx < n_total - 2, key, (1 << 25) + idx)
    pos = torch.arange(n, device=dev) + WINDOW
    best_len = torch.zeros(n, dtype=torch.int64, device=dev)
    best_src = torch.zeros(n, dtype=torch.int64, device=dev)
    for ln in range(3, MAX_CODED + 1):
        skey, spos = torch.sort(key, stable=True)
        # nearest source at recency distance >= ln (d descending, so the
        # closest valid predecessor is written last)
        src = torch.full((n_total,), -1, dtype=torch.int64, device=dev)
        for d in range(ln, 0, -1):
            prev_pos = torch.roll(spos, d)
            ok = ((idx >= d) & (torch.roll(skey, d) == skey)
                  & (spos - prev_pos >= ln))
            src = torch.where(ok, prev_pos, src)
        grp = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         (skey[1:] != skey[:-1]).long()])
        src_lin = torch.empty_like(src)
        src_lin[spos] = src
        rank = torch.empty_like(src)
        rank[spos] = torch.cumsum(grp, 0)
        s = src_lin[WINDOW: WINDOW + n]
        valid = (s >= 0) & (s >= pos - WINDOW) & ((pos - WINDOW) + ln <= n)
        best_len = torch.where(valid, ln, best_len)
        best_src = torch.where(valid, s, best_src)
        if ln < MAX_CODED:
            inside = idx < n_total - ln
            key = torch.where(
                inside, rank * 256 + torch.where(inside, torch.roll(p, -ln), 0),
                (1 << 30) + idx)
    return best_len, best_src


def _stitched_best(padded: torch.Tensor, n: int):
    """Best ring-wrapping match per position (brute.c matches sources
    whose ring segment crosses windowHead: the first c bytes come from
    the newest window bytes, the rest wrap to bytes 4096 earlier) ->
    (len, src), src the linear start of the first segment.  Every read
    is a static slice of `padded`."""
    dev = padded.device
    pos = torch.arange(n, device=dev) + WINDOW
    best_len = torch.zeros(n, dtype=torch.int64, device=dev)
    best_src = torch.zeros(n, dtype=torch.int64, device=dev)
    cur = [padded[WINDOW + j: WINDOW + j + n] for j in range(MAX_CODED)]
    for c in range(1, MAX_CODED):
        still = torch.ones(n, dtype=torch.bool, device=dev)
        ln = torch.zeros(n, dtype=torch.int64, device=dev)
        for j in range(MAX_CODED):
            srcb = (padded[WINDOW - c + j: WINDOW - c + j + n]
                    if j < c else padded[j - c: j - c + n])
            still = still & (srcb == cur[j])
            ln = ln + still.long()
        # only a true stitch (first segment fully matched) may exceed c
        ln = torch.minimum(ln, torch.where(ln >= c, MAX_CODED, c))
        ln = torch.minimum(ln, n - (pos - WINDOW))
        take = ln > best_len
        best_len = torch.where(take, ln, best_len)
        best_src = torch.where(take, pos - c, best_src)
    return best_len, best_src


def lzss_encode_device(data: torch.Tensor, k_cand: int, out_words: int,
                       exact: bool = False, n_valid: int | None = None):
    """Encode uint8[n] -> (words int64[out_words] holding uint32 values,
    total_bits int64 0-dim), on the device `data` lies on.

    The bitstream decodes with the reference lzss-0.6.2 decoder byte for
    byte (zero-padded final byte, as bitfile does).  `n_valid` (default
    n) keeps only the tokens that start before it: the driver pads a
    tail block with zeros to tpulc's power-of-two bucket, and the last
    kept token may run into the padding (the decoder's caller trims)."""
    n = data.shape[0]
    dev = data.device
    pad_tail = MAX_CODED + 2  # so the word extension never reads past
    padded = torch.cat([
        torch.full((WINDOW,), 32, dtype=torch.uint8, device=dev), data,
        torch.zeros(pad_tail, dtype=torch.uint8, device=dev)])
    if exact:
        with timing.stage("lzss.candidates"):
            best_len, best_src = _exact_best_match(padded, n)
        with timing.stage("lzss.extend"):
            st_len, st_src = _stitched_best(padded, n)
            take = st_len > best_len
            best_len = torch.where(take, st_len, best_len)
            best_src = torch.where(take, st_src, best_src)
    else:
        with timing.stage("lzss.candidates"):
            cand = _match_candidates(padded, k_cand)
        with timing.stage("lzss.extend"):
            best_len, best_src = _extend(padded, cand, n)
            del cand

    with timing.stage("lzss.parse"):
        is_match = best_len > MAX_UNCODED
        step = torch.where(is_match, best_len, 1)
        idx = torch.arange(n, device=dev)
        jump_e = torch.cat([(idx + step).clamp(max=n),
                            torch.full((1,), n, dtype=torch.int64, device=dev)])
        is_start = orbit_flags(jump_e, n, n)

    with timing.stage("lzss.pack"):
        off_ring = best_src % WINDOW
        adj = (best_len - (MAX_UNCODED + 1)).clamp(0, 15)
        match_code = ((off_ring & 0xFF) << 8) | (((off_ring >> 8) & 0xF) << 4) \
            | adj
        lit_code = (1 << 8) | data.to(torch.int64)
        code = torch.where(is_match, match_code, lit_code)
        if n_valid is not None:
            is_start = is_start & (idx < n_valid)
        nbits = torch.where(is_start, torch.where(is_match, 17, 9), 0)
        return pack_bits(code, nbits, out_words)

"""Parallel LZSS decoder for the Dipperstein 12/4 bitstream (port of
`tpulc/codecs/lzss/decode.py`; the same bytes), batched over blocks.

Two parallel stages replace the reference's serial decoder
(lzss-0.6.2 `lzdecode.c:131`):

  1. Token boundaries: tokens are 9 bits (flag 1 + char) or 17 bits
     (flag 0 + offset + len), so a token straddles a subsequence
     boundary by at most 16 bits, and the state crossing a boundary is
     one of 17 entry offsets.  Walking every 512-bit subsequence from
     each entry gives an entry -> exit map and an output byte count;
     maps compose associatively (`huffman.decode._compose_scan`), which
     gives each subsequence its true entry and output offset; a second
     walk writes each token's code at its output position.
  2. Copy resolution: each output byte's source is a literal, a
     virtual-window space, or an earlier output byte (matches copy the
     pre-token window, `lzdecode.c:205-220`, so sources are strictly
     earlier); pointer doubling to a fixpoint resolves the copy forest.

Both walks loop until no subsequence is active, asking the device once
a step (tpulc's `while_loop`s); `lzss_decode_device.synced_steps` counts
those steps, and the doubling's rounds, which also ask once a round.
tpulc reads the stream through `byte_windows` / `peek_bits_bw`, a TPU
layout; here `peek_bits` reads word pairs.  tpulc `vmap`s blocks; here
blocks are a leading axis, their streams one flat word array.
"""

from __future__ import annotations

import torch

from tpulc_torch.codecs.huffman.decode import _compose_scan
from tpulc_torch.primitives.bits import M32, peek_bits
from tpulc_torch.utils import timing

WINDOW = 4096
N_STATES = 17
SUB_BITS = 512


def _token_fields(v17: torch.Tensor):
    """A peeked 17-bit window -> (is_lit, char, off, length)."""
    is_lit = (v17 >> 16) & 1
    char = (v17 >> 8) & 0xFF
    off = ((v17 >> 8) & 0xFF) | (((v17 >> 4) & 0xF) << 8)
    length = (v17 & 0xF) + 3
    return is_lit, char, off, length


def _walk(flat, base, pos, end, total, out, sink=None):
    """Walk tokens from bit `pos` (block-local) until `end`, per lane;
    `base` is the lane's block start in the flat stream and `total` its
    block's valid bits.  A token that would run past the stream is
    discarded (the reference breaks on EOF mid-read, lzdecode.c:172).
    Adds each kept token's output bytes to `out`.  With `sink` =
    (code_arr, start, obase, n_out), also writes each kept token's code
    and a start flag at flat index obase + min(out, n_out); the last
    entry of the flat arrays takes the tokens not kept.
    -> (pos, out, steps)."""
    steps = 0
    while True:
        active = pos < end
        if not bool(active.any()):
            return pos, out, steps
        steps += 1
        v17 = peek_bits(flat, base + torch.minimum(pos, total), N_STATES)
        is_lit, _, _, length = _token_fields(v17)
        tok_bits = torch.where(is_lit == 1, 9, 17)
        fits = pos + tok_bits <= total
        emit = active & fits
        if sink is not None:
            code_arr, start, obase, n_out = sink
            tgt = torch.where(emit, obase + out.clamp(max=n_out),
                              code_arr.shape[0] - 1)
            code_arr[tgt] = v17
            start[tgt] = True
        pos = torch.where(active, torch.where(fits, pos + tok_bits, end), pos)
        out = out + torch.where(emit, torch.where(is_lit == 1, 1, length), 0)


def lzss_decode_device(words: torch.Tensor, total_bits: torch.Tensor,
                       n_out: int):
    """Decode B MSB-first bitstreams, integer words [B, W] (uint32
    values) with `total_bits` int [B] valid bits each ->
    (uint8 [B, n_out], n_valid int64 [B]): n_valid is the byte count
    each stream holds; bytes past it (or past n_out) are not written.
    Each row needs a zero word after its stream (a peek reads on into
    the next row's words)."""
    dev = words.device
    B, W = words.shape
    nsub = max(1, -(-(W * 32) // SUB_BITS))
    flat = words.to(torch.int64).reshape(-1) & M32
    tb = total_bits.to(device=dev, dtype=torch.int64)
    blk = torch.arange(B, device=dev)[:, None]
    sub = torch.arange(nsub, device=dev)[None, :] * SUB_BITS
    steps = 0

    with timing.stage("lzss.walks"):
        # walk 1: every subsequence from each of the 17 entry offsets
        ent = torch.arange(N_STATES, device=dev)
        pos, cnt, k = _walk(
            flat, (blk * (W * 32))[..., None], (sub[..., None] + ent),
            (sub + SUB_BITS)[..., None], tb[:, None, None],
            torch.zeros(B, nsub, N_STATES, dtype=torch.int64, device=dev))
        steps += k
        next_map = (pos - (sub + SUB_BITS)[..., None]).clamp(0, N_STATES - 1)
        # scan along subsequences: [nsub, B, 17]
        incl_next, incl_cnt = _compose_scan(next_map.transpose(0, 1),
                                            cnt.transpose(0, 1))
        zero = torch.zeros(1, B, dtype=torch.int64, device=dev)
        entry = torch.cat([zero, incl_next[:-1, :, 0]]).T
        offset = torch.cat([zero, incl_cnt[:-1, :, 0]]).T
        n_valid = incl_cnt[-1, :, 0]

        # walk 2: from each subsequence's true entry, each token's code
        # and a start flag at its output position (one drop slot a row)
        row = n_out + 1
        code_arr = torch.zeros(B * row + 1, dtype=torch.int64, device=dev)
        start = torch.zeros(B * row + 1, dtype=torch.bool, device=dev)
        _, _, k = _walk(flat, blk * (W * 32), sub + entry, sub + SUB_BITS,
                        tb[:, None], offset,
                        (code_arr, start, blk * row, n_out))
        steps += k
    return _resolve(code_arr[:-1].reshape(B, row), start[:-1].reshape(B, row),
                    n_valid, n_out, steps)


def _resolve(code_arr, start, n_valid, n_out: int, steps: int):
    """Phase 3: each byte's source, then pointer doubling to a fixpoint
    (worst case log2(total) rounds; real copy forests resolve in a
    handful)."""
    dev = code_arr.device
    B = code_arr.shape[0]
    with timing.stage("lzss.doubling"):
        idx = torch.arange(n_out, device=dev)[None, :].expand(B, n_out)
        tok_start = torch.cummax(torch.where(start[:, :n_out], idx, -1),
                                 1).values
        ts = tok_start.clamp(min=0)
        v17 = torch.gather(code_arr, 1, ts)
        is_lit, char, off, _ = _token_fields(v17)
        # ring index of this byte's source, then back to linear coords
        w = (off + idx - ts) % WINDOW
        p_pad = ts + WINDOW
        q = p_pad - 1 - ((p_pad - 1 - w) % WINDOW)
        valid = (tok_start >= 0) & (idx < n_valid[:, None])
        lit_mask = (is_lit == 1) & valid
        total = n_out + WINDOW
        # literals and spaces (the virtual window, bytes past n_valid)
        # are roots; a match byte points at its source
        src = torch.where((is_lit == 0) & valid, q, idx + WINDOW)
        src = torch.cat([torch.arange(WINDOW, device=dev).expand(B, WINDOW),
                         src], dim=1)
        vals = torch.cat([
            torch.full((B, WINDOW), 32, dtype=torch.uint8, device=dev),
            torch.where(lit_mask, char, 32).to(torch.uint8)], dim=1)
        # one flat forest over the blocks
        src = (src + torch.arange(B, device=dev)[:, None] * total).reshape(-1)
        rounds = max(1, (total - 1).bit_length())
        for _ in range(rounds):
            nxt = src[src]
            steps += 1
            if bool((nxt == src).all()):
                break
            src = nxt
        out = vals.reshape(-1)[src].reshape(B, total)[:, WINDOW:]
    lzss_decode_device.synced_steps += steps
    return out, n_valid


lzss_decode_device.synced_steps = 0

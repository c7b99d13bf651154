"""ST-k bounded-context sort transform (Schindler transform), port of
`tpulc/codecs/bwt/stk.py` (last column, next-char stream, idx0,
context keys, predecessor permutation and inverse bit-identical).

Forward: each position's key is its next k bytes (cyclic), one stable
sort with position tiebreak orders the positions, and the output is
the byte before each sorted position plus the row of position 0.
tpulc sorts several uint32 operands with `lax.sort` and reads the
cyclic neighbours through a doubled buffer; here the k bytes pack
big-endian and left-aligned into one int64 whose top byte is offset by
-128, so that signed order is the unsigned order of the bytes, and one
`torch.sort(stable=True)` orders them; the neighbours are gathers at
(i + t) mod n.  The masked forms work on the first n bytes of a
zero-padded buffer of capacity cap: tpulc's pad rows sort after every
real row and never move, so here they stay out of the sort.

Inverse, hybrid: each slot's k-byte context is rebuilt on the block's
device by the prepend-sort identity (`st_context_keys`: context char t
of slot j is context char t-1 of slot P[j], P the stable sort by the
last column), the keys and the last column come to the host in one
copy, and the serial backward walk runs there (`gold/st_inverse.c`).

Inverse, wired (`st8w`): with the next-char stream F the predecessor
relation is a static permutation (two stable sorts of (k+1)-byte keys,
`st_predecessor_perm_masked`), and a pointer-doubling walk of
ceil(log2 cap) gather rounds restores the text on the device.  The
9-byte keys of k = 8 sort as two stable passes, the low byte first.

tpulc's unmasked `st_encode`, `st_encode_with_next`,
`st_predecessor_perm`, `st_decode_device`, `st_context_keys_masked`
and `st_encode_np` are not ported: only tpulc's tests reach them.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulc_torch.gold.st_inverse import st_inverse
from tpulc_torch.utils import timing


def _pack8(cols: list[torch.Tensor]) -> torch.Tensor:
    """Up to 8 byte columns (int64 values 0..255) -> int64 keys: the
    bytes big-endian and left-aligned in 64 bits, the top byte offset
    by -128 so that signed order is the bytes' unsigned order."""
    key = (cols[0] - 128) << 56
    for t, c in enumerate(cols[1:8], 1):
        key = key + (c << (56 - 8 * t))
    return key


def _cyclic(d: torch.Tensor, k: int) -> list[torch.Tensor]:
    """d int64[n] -> [d[(i + t) mod n] for t < k]."""
    n = d.shape[0]
    i = torch.arange(n, device=d.device)
    return [d] + [d[(i + t) % n] for t in range(1, k)]


def _sorted_positions(data: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Positions of the first n bytes sorted by their next k bytes
    (cyclic), ties by position."""
    d = data[:n].to(torch.int64)
    return torch.sort(_pack8(_cyclic(d, k)), stable=True).indices


def _primary(order: torch.Tensor) -> torch.Tensor:
    """The row of position 0, as an int64 0-dim tensor (no host sync)."""
    return torch.argmax((order == 0).to(torch.int8))


def st_encode_masked(data: torch.Tensor, n: int, k: int = 8):
    """ST-k of the first n bytes of uint8[cap] -> (last uint8[cap], 0
    past n; idx0 int64 0-dim tensor, 0 when n = 0)."""
    cap = data.shape[0]
    dev = data.device
    last = torch.zeros(cap, dtype=torch.uint8, device=dev)
    if n == 0:
        return last, torch.zeros((), dtype=torch.int64, device=dev)
    order = _sorted_positions(data, n, k)
    last[:n] = data[(order - 1) % n]
    return last, _primary(order)


def st_encode_with_next_masked(data: torch.Tensor, n: int, k: int = 8):
    """`st_encode_masked` plus the next-char stream F (valid prefix n):
    F[j] = data[(pos(j) + k) mod n] -> (last, fnext uint8[cap], idx0)."""
    cap = data.shape[0]
    dev = data.device
    last = torch.zeros(cap, dtype=torch.uint8, device=dev)
    fnext = torch.zeros(cap, dtype=torch.uint8, device=dev)
    if n == 0:
        return last, fnext, torch.zeros((), dtype=torch.int64, device=dev)
    order = _sorted_positions(data, n, k)
    last[:n] = data[(order - 1) % n]
    fnext[:n] = data[(order + k) % n]
    return last, fnext, _primary(order)


def _context_chars(last: torch.Tensor, k: int) -> list[torch.Tensor]:
    """The k context chars (int64[n] each) of every slot of the last
    column uint8[n]: char 0 is the sorted last column, char t of slot j
    is char t-1 of slot P[j]."""
    s, P = torch.sort(last.to(torch.int64), stable=True)
    chars = [s]
    for _ in range(k - 1):
        chars.append(chars[-1][P])
    return chars


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def st_context_keys(last: torch.Tensor, k: int = 8):
    """Each slot's k-byte context from the last column uint8[n] ->
    (hi, lo) int64[n], tpulc's uint32 key words (left-aligned, zero low
    bytes when k < 8)."""
    key = _pack8(_context_chars(last, k))
    return (key >> 32) + (1 << 31), key & 0xFFFFFFFF


def st_decode(last: torch.Tensor, idx0: int, k: int = 8) -> np.ndarray:
    """Inverse ST-k of last uint8[n] (on any device) -> uint8[n] on the
    host: the context keys on last's device, one copy of keys and last
    column to the host, the C walk (`gold/st_inverse.py`, which raises
    ValueError for an idx0 outside [0, n) or a failed walk; timed as
    the stage `bsc.unsort.walk`)."""
    n = last.shape[0]
    hi, lo = st_context_keys(last, k)
    keys = torch.stack([_u32(hi), _u32(lo)]).view(torch.uint8).reshape(-1)
    buf = torch.cat([keys, last.to(torch.uint8)]).cpu().numpy()
    words = buf[: 8 * n].view(np.uint32).reshape(2, n)
    with timing.stage("bsc.unsort.walk"):
        return st_inverse(buf[8 * n:], words[0], words[1], idx0, k)


def _gram_order(cols: list[torch.Tensor], tie: torch.Tensor | None):
    """Stable order of up to 9 byte columns (big-endian), then `tie`
    (0/1, or None), then position: two stable passes, (byte 8, tie)
    first, then the 64-bit key of bytes 0..7."""
    n = cols[0].shape[0]
    zero = torch.zeros(n, dtype=torch.int64, device=cols[0].device)
    cols = cols + [zero] * (9 - len(cols))
    low = cols[8] * 2 + (0 if tie is None else tie)
    o1 = torch.sort(low, stable=True).indices
    return o1[torch.sort(_pack8(cols[:8])[o1], stable=True).indices]


def st_predecessor_perm_masked(last: torch.Tensor, fnext: torch.Tensor,
                               idx0: int, n: int, k: int = 8) -> torch.Tensor:
    """Static predecessor permutation int64[cap] of the ST-k slots over
    the valid prefix n (the identity on pad rows): slot j (position p)
    and its predecessor (position p-1) both name the cyclic (k+1)-gram
    at p-1, j through L[j] ++ ctx[j] and the predecessor through ctx ++
    F; equal grams pair in position order, except that the child at
    position 0 (idx0) pairs with the parent at n-1, so an extra key
    sends it to the end of its gram group."""
    cap = last.shape[0]
    dev = last.device
    perm = torch.arange(cap, device=dev)
    if n == 0:
        return perm
    chars = _context_chars(last[:n], k)
    wrap = (torch.arange(n, device=dev) == idx0).to(torch.int64)
    child = _gram_order([last[:n].to(torch.int64)] + chars, wrap)
    parent = _gram_order(chars + [fnext[:n].to(torch.int64)], None)
    perm[child] = parent
    return perm


def st_decode_device_masked(last: torch.Tensor, fnext: torch.Tensor,
                            idx0: int, n: int, k: int = 8) -> torch.Tensor:
    """Inverse ST-k on the device (wired F) over the valid prefix n of
    uint8[cap] -> uint8[cap], the text in [0, n): the predecessor
    permutation, then pointer doubling over ceil(log2 cap) rounds (each
    slot's distance to idx0 along it), and each in-cycle slot's byte
    placed at its distance."""
    cap = last.shape[0]
    dev = last.device
    idx = torch.arange(cap, device=dev)
    last = torch.where(idx < n, last, 0)
    ptr = st_predecessor_perm_masked(last, fnext, idx0, n, k)
    d = torch.ones(cap, dtype=torch.int64, device=dev)
    for _ in range(max(1, (cap - 1).bit_length())):
        live = ptr != idx0
        nptr, nd = ptr[ptr], d + d[ptr]
        ptr = torch.where(live, nptr, ptr)
        d = torch.where(live, nd, d)
    # a valid stream's cycle holds its n rows; the clamp keeps a hostile
    # one's reads in range (its text then fails the checksum)
    p = d[idx0].clamp(1, cap)
    slot = torch.where(ptr == idx0, (p - d) % p, cap)
    cyc = torch.zeros(cap + 1, dtype=torch.uint8, device=dev)
    cyc[slot] = last
    return cyc[(n - 1 - idx) % p]

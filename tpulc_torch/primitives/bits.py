"""Bit packing and peeking (port of `tpulc/primitives/bits.py`:
`pack_bits`, `peek_bits`).

Bit order (the whole framework's convention): MSB-first within a 32-bit
word, words in increasing order.

tpulc assembles words with a segmented OR-scan and a compaction sort,
because a scatter costs ~2.5x a sort on the TPU (`bits.py:7-13`).  On
the GPU the direct idiom is cheaper: every field occupies bits of at
most two words, fields are disjoint, so OR equals add, and two
`scatter_add_`s (the low part into its word, the spill into the next)
build the stream.  The arithmetic runs in int64 holding uint32 values
(PyTorch's uint32 shifts are only partly supported), masked to 32 bits;
the wire converts to little-endian uint32 at the end.

tpulc's `byte_windows` / `peek_bits_bw` (a 4x-memory layout that saves
one TPU gather per probe) are not ported: a GPU gather of the word pair
is cheap.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def pack_fields_np(vals: np.ndarray, width: int) -> bytes:
    """Host wire fields: uint values (< 2^width) -> MSB-first bit-packed
    bytes (the bz and bsc payloads' deltas, selectors and anchors)."""
    v = vals.astype(np.uint32)
    bits = (
        (v[:, None] >> np.arange(width - 1, -1, -1, dtype=np.uint32)) & 1
    ).astype(np.uint8)
    return np.packbits(bits.reshape(-1)).tobytes()


def unpack_fields_np(buf: bytes, width: int, count: int) -> np.ndarray:
    """Inverse of `pack_fields_np` -> int64[count]."""
    if count == 0:
        return np.zeros(0, np.int64)
    bits = np.unpackbits(
        np.frombuffer(buf, np.uint8), count=count * width
    ).reshape(count, width).astype(np.uint32)
    w = np.arange(width - 1, -1, -1, dtype=np.uint32)
    return (bits << w).sum(axis=1).astype(np.int64)


def pack_bits(codes: torch.Tensor, lengths: torch.Tensor, out_words: int):
    """Pack variable-length codes into dense MSB-first bitstreams.

    Args:
      codes: integer [..., N], each code right-aligned in its low
        `lengths[i]` bits (value < 2**lengths[i]; the OR-as-add assembly
        relies on it).
      lengths: integer [..., N], bit length per code in [0, 32].
      out_words: output size in 32-bit words, with
        ``out_words*32 >= sum(lengths)`` along the last axis.

    Leading axes are independent streams (tpulc `vmap`s the 1-D form).

    Returns:
      (words int64[..., out_words] holding uint32 values, total_bits
      int64[...]) — bit-identical to tpulc's (uint32 words, int32).
    """
    dev = codes.device
    lead = codes.shape[:-1]
    n = codes.shape[-1]
    if n == 0:
        return (torch.zeros(*lead, out_words, dtype=torch.int64, device=dev),
                torch.zeros(lead, dtype=torch.int64, device=dev))
    codes = codes.reshape(-1, n).to(torch.int64) & M32
    lengths = lengths.reshape(-1, n).to(torch.int64)
    off = torch.cumsum(lengths, 1) - lengths
    total_bits = off[:, -1] + lengths[:, -1]
    word = off >> 5
    bit = off & 31
    # field occupies bits [bit, bit+len) of `word`, spilling into word+1
    shift = 32 - bit - lengths
    lo = torch.where(shift >= 0, codes << shift.clamp(0, 31),
                     codes >> (-shift).clamp(0, 31)) & M32
    hi = torch.where(shift < 0, (codes << (32 + shift).clamp(0, 31)) & M32, 0)
    live = lengths > 0
    lo = torch.where(live, lo, 0)
    hi = torch.where(live, hi, 0)
    # +2: a zero-length item at the very end may index out_words + 1
    words = torch.zeros(codes.shape[0], out_words + 2, dtype=torch.int64,
                        device=dev)
    words.scatter_add_(1, word, lo)
    words.scatter_add_(1, word + 1, hi)
    return ((words[:, :out_words] & M32).reshape(*lead, out_words),
            total_bits.reshape(lead))


def peek_bits(words: torch.Tensor, bitpos: torch.Tensor,
              width: int) -> torch.Tensor:
    """Read `width` (1..32) bits at absolute MSB-first bit positions.

    `words` is int64[W] holding uint32 values (as `pack_bits` returns);
    `bitpos` holds non-negative positions.  Bits past the stream read as
    zero (tpulc pads the stream with zero words instead).  Returns int64
    values right-aligned in the low `width` bits.
    """
    W = words.shape[0]
    pos = bitpos.to(torch.int64)
    wi = pos >> 5
    b = pos & 31

    def word(i):
        return torch.where(i < W, words[i.clamp(max=W - 1)], 0)

    if W == 0:
        return torch.zeros_like(pos)
    merged = ((word(wi) << b) & M32) | (word(wi + 1) >> (32 - b))
    return merged >> (32 - width)

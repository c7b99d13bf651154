"""Parallel Huffman encode (port of `tpulc/codecs/huffman/encode.py`).

cudpp encodes per 4096-char block with per-thread serial bit counts and
atomicOr packing (`huffman_kernel_en`, `compress_kernel.cuh:2525-2716`);
here, as in tpulc, it is one op chain with no atomics: gather
(code, length) per byte, then `pack_bits` (exclusive cumsum of the
lengths, disjoint-bit scatter-adds into 32-bit words).
"""

from __future__ import annotations

import torch

from tpulc_torch.primitives.bits import pack_bits


def huffman_encode(data: torch.Tensor, codes: torch.Tensor,
                   lengths: torch.Tensor, out_words: int):
    """Encode uint8[N] with per-symbol (codes, lengths) tables.

    Args:
      data: uint8[N].
      codes: integer[S] right-aligned canonical codes.
      lengths: integer[S] code lengths.
      out_words: output word count (>= ceil(N*max_len/32)).

    Returns:
      (words int64[out_words] holding uint32 values, total_bits int64).
    """
    idx = data.to(torch.int64)
    return pack_bits(codes.to(data.device)[idx], lengths.to(data.device)[idx],
                     out_words)

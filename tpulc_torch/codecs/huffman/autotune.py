"""Subsequence-size autotune for the self-sync Huffman decoder, copied
from `tpulc/codecs/huffman/autotune.py` (host code; the self-sync path
of `driver.decompress_block` picks its subsequence size with it, so the
two packages split a stream alike).

CUHD picks its subsequence size from the compression ratio
(`CUHDUtil::optimal_subsequence_size`, `src/cuhd_util.cc:24-56`): denser
streams decode more symbols per subsequence, so larger subsequences
amortize better.  The driving statistic is the expected symbols per
subsequence = sub_bits / avg_code_len.
"""

from __future__ import annotations


def optimal_sub_bits(
    total_bits: int,
    n_symbols: int,
    max_len: int,
    min_sub_bits: int = 128,
    max_sub_bits: int = 4096,
    target_lanes: int = 2048,
) -> int:
    """Pick the self-sync decoder's subsequence size.

    Aims for ~target_lanes subsequences while keeping the serial symbol
    loop short; clamps to [min_sub_bits, max_sub_bits] and rounds to a
    32-bit unit multiple.
    """
    if total_bits <= 0 or n_symbols <= 0:
        return min_sub_bits
    ideal = total_bits / max(target_lanes, 1)
    sub = int(ideal // 32) * 32
    sub = max(min_sub_bits, min(max_sub_bits, sub))
    # never smaller than ~4 max-length codewords, or the entry-state
    # overhead (L lanes per subsequence) dominates
    sub = max(sub, ((4 * max_len + 31) // 32) * 32)
    return sub

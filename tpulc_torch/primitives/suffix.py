"""Suffix array construction by prefix doubling (port of
`tpulc/primitives/suffix.py`; the same arrays).

The counterpart of cudpp's `cudppSuffixArray` (recursive DC3 on cub
radix sorts, `sa_app.cu:125-365`; the device DC3 is
`primitives/dc3_device.py`).  Each round sorts the suffixes by
(rank[i], rank[i+k]), with -1 past the end so that a shorter suffix
sorts first, and doubles k; both keys go into one int64, so a round is
one stable `torch.sort` (CUB's radix sort on the card).  tpulc's
`while_loop` is a host loop that reads on the host, once a round,
whether the ranks are unique; `suffix_array.rounds` holds the last
call's count of doubling rounds.

Also the BWT-from-SA finalisation (`bwt_compute_final_kernel`,
`compress_kernel.cuh:56-74`) and the naive gold.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulc_torch.codecs.bwt.rotsort import (
    _scatter_perm,
    _stable_multikey_order,
)


def _dense_rank(keys: list[torch.Tensor], highs: list[int]):
    """Dense 0-based rank of each row under ascending lexicographic key
    order (ties share a rank; key j in [0, highs[j]]) -> int64."""
    order, diff = _stable_multikey_order(keys, highs)
    grp = torch.cat([torch.zeros(1, dtype=torch.int64, device=diff.device),
                     diff.to(torch.int64)])
    return _scatter_perm(order, torch.cumsum(grp, 0))


def suffix_array(data: torch.Tensor) -> torch.Tensor:
    """SA of uint8[n] -> int64[n]: SA[j] = start of the j-th smallest
    suffix."""
    n = data.shape[0]
    idx = torch.arange(n, device=data.device)
    rank = _dense_rank([data], [255])
    k, rounds = 1, 0
    while k < n and int(rank.max()) < n - 1:
        # suffix i+k runs off the end -> -1, here 0 after a shift by one
        key2 = torch.where(idx + k < n, torch.roll(rank, -k) + 1, 0)
        rank = _dense_rank([rank, key2], [n - 1, n])
        k *= 2
        rounds += 1
    suffix_array.rounds = rounds
    return _scatter_perm(rank, idx)


suffix_array.rounds = 0


def sa_to_bwt(data: torch.Tensor, sa: torch.Tensor):
    """cudpp-style BWT finalisation: bwt[j] = data[SA[j]-1] (wrapping)
    and the index of the row where SA[j] == 0
    (`compress_kernel.cuh:56-74`)."""
    n = data.shape[0]
    bwt = data[torch.remainder(sa - 1, n)]
    return bwt, torch.argmax((sa == 0).to(torch.int8))


def suffix_array_np(data) -> np.ndarray:
    """Naive gold (cudpp `computeSaGold` role, `sa_gold.cpp:42`)."""
    arr = bytes(np.asarray(data, np.uint8))
    return np.asarray(
        sorted(range(len(arr)), key=lambda i: arr[i:]), np.int32
    )

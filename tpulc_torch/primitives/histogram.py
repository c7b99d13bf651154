"""Byte histograms (port of `tpulc/primitives/histogram.py`; the same
counts) and the histogram of masked prefixes that the bz and bsc
transforms and the sharded steps take.

cudpp's shared-memory histogram kernel (`huffman_build_histogram_kernel`,
`compress_kernel.cuh:2037-2128`) is one `bincount` here.  tpulc counts a
batch with a one-hot matmul so that it runs on the MXU; one `bincount`
over row * bins + byte gives the same integers.  Values at or past
`num_bins` count nowhere, as tpulc's dropped scatter and zero one-hot
rows do.
"""

from __future__ import annotations

import torch


def byte_histogram(data: torch.Tensor, num_bins: int = 256) -> torch.Tensor:
    """Histogram of uint8 data -> int64[num_bins]."""
    return torch.bincount(data.reshape(-1).to(torch.int64),
                          minlength=num_bins)[:num_bins]


def batched_byte_histogram(blocks: torch.Tensor,
                           num_bins: int = 256) -> torch.Tensor:
    """Per-row histogram of uint8[B, N] -> int64[B, num_bins]."""
    B = blocks.shape[0]
    b = blocks.to(torch.int64)
    row = torch.arange(B, device=b.device)[:, None]
    idx = torch.where(b < num_bins, row * num_bins + b, B * num_bins)
    counts = torch.bincount(idx.reshape(-1), minlength=B * num_bins + 1)
    return counts[: B * num_bins].view(B, num_bins)


def prefix_hist(x: torch.Tensor, n, bins: int) -> torch.Tensor:
    """Histogram of the first n entries of each row of an integer
    [..., L] tensor, summed over the rows -> int64[bins].  n is one
    count (a 0-dim tensor or an int) or one count a row.  (tpulc's are a
    sort and a `searchsorted`; a `bincount` gives the same integers.)"""
    n = torch.as_tensor(n, device=x.device)
    live = torch.arange(x.shape[-1], device=x.device) < n[..., None]
    idx = torch.where(live, x.to(torch.int64), bins)
    return torch.bincount(idx.reshape(-1), minlength=bins + 1)[:bins]

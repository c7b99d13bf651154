"""Histograms of masked prefixes (tpulc's are a sort and a
`searchsorted`; a `bincount` gives the same integers)."""

from __future__ import annotations

import torch


def prefix_hist(x: torch.Tensor, n, bins: int) -> torch.Tensor:
    """Histogram of the first n entries of each row of an integer
    [..., L] tensor, summed over the rows -> int64[bins].  n is one
    count (a 0-dim tensor or an int) or one count a row."""
    n = torch.as_tensor(n, device=x.device)
    live = torch.arange(x.shape[-1], device=x.device) < n[..., None]
    idx = torch.where(live, x.to(torch.int64), bins)
    return torch.bincount(idx.reshape(-1), minlength=bins + 1)[:bins]

"""The hand kernels' costs, one module per wrapper of the program.

Each module names the wrapper (`WRAPPER`, "module:function"), the CUDA
kernels one call launches (`KERNELS`, `PER_CALL` of them a call; memsets
are not counted) and `cost(args, kwargs, out) -> (bytes, operations)`:
the least the card must move and compute for that call, counted as the
port's kernel table counts them (every tensor read once and written
once unless the module says otherwise; integer operations a step from
the function the kernel computes, not from its design).  A call's
bound is the larger of bytes over the peak memory rate and operations
over the peak integer rate (`../peaks.json`).
"""

from __future__ import annotations

import torch


def nbytes(*xs) -> int:
    """Bytes of every tensor in xs, looking into tuples and lists."""
    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
    return total

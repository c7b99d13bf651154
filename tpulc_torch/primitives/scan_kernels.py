"""The inclusive running max and min of a 1-D integer tensor: wrappers,
launch counts and plain versions.

tpulc runs these as `jax.lax.associative_scan(jnp.maximum /
jnp.minimum, x, reverse=...)` under XLA, with no `pallas_call`
(`tpulc/codecs/bwt/rle.py:43,46,78,103`, `rotsort.py:148`,
`bsclike/grc.py:165,299`).  On the card `torch.cummax` / `torch.cummin`
took ~3 ms a call on a bz block and ~77 ms on a 25 MiB bsc block, far
off their bytes bound, so they are a hand kernel here: the CUDA source
is `tpulc_torch/csrc/scan.cu` (design notes there).

| wrapper       | computes                                   |
|---------------|--------------------------------------------|
| `running_max` | y[i] = max(x[:i+1]), or max(x[i:]) reverse |
| `running_min` | y[i] = min(x[:i+1]), or min(x[i:]) reverse |

Both take int32 or int64 and return x's dtype.  A wrapper given a CPU
tensor runs the plain PyTorch version; given a CUDA tensor it launches
the kernel (and adds one to its `launches` count) or raises — it never
falls back.  The primitive layer's own scans (`parallel.py`) stay plain
torch.
"""

from __future__ import annotations

import torch

from tpulc_torch import cuda_lib

DTYPES = (torch.int32, torch.int64)


def _check(x: torch.Tensor) -> None:
    if x.dtype not in DTYPES or x.dim() != 1:
        raise ValueError(f"x: need a 1-D int32 or int64 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[0] >= 1 << 31:
        raise ValueError("x: at most 2^31 - 1 elements")
    cuda_lib.device_of(x)


def running_max_plain(x: torch.Tensor, reverse: bool = False):
    """y[i] = max(x[:i+1]) (reverse: max(x[i:]))."""
    if reverse:
        return torch.flip(torch.cummax(torch.flip(x, (0,)), 0).values, (0,))
    return torch.cummax(x, 0).values


def running_min_plain(x: torch.Tensor, reverse: bool = False):
    """y[i] = min(x[:i+1]) (reverse: min(x[i:]))."""
    if reverse:
        return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))
    return torch.cummin(x, 0).values


def _launch(x: torch.Tensor, is_max: bool, reverse: bool, name: str):
    lib = cuda_lib.library()
    x = x.contiguous()
    n = x.shape[0]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        # the look-back's counter, flags and tile values (bytes)
        scratch = torch.empty(lib.tplc_running_scan_scratch(n),
                              dtype=torch.uint8, device=x.device)
        cuda_lib.check(lib.tplc_running_scan(
            x.data_ptr(), y.data_ptr(), scratch.data_ptr(), n,
            x.element_size(), int(is_max), int(reverse),
            cuda_lib.stream_of(x)), name)
    return y


def running_max(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Kernel wrapper (see `running_max_plain`)."""
    _check(x)
    if x.device.type == "cpu":
        return running_max_plain(x, reverse)
    if x.shape[0] == 0:   # nothing to launch
        return torch.empty_like(x)
    y = _launch(x, True, reverse, "running_max")
    running_max.launches += 1
    return y


running_max.launches = 0


def running_min(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Kernel wrapper (see `running_min_plain`)."""
    _check(x)
    if x.device.type == "cpu":
        return running_min_plain(x, reverse)
    if x.shape[0] == 0:   # nothing to launch
        return torch.empty_like(x)
    y = _launch(x, False, reverse, "running_min")
    running_min.launches += 1
    return y


running_min.launches = 0

"""MTF kernels K1, K2, K4: wrappers, launch counts and plain versions.

The counterpart of `tpulc/primitives/mtf_pallas.py`.  The CUDA sources
are `tpulc_torch/csrc/mtf.cu` (design notes there).

| kernel | wrapper                   | replaces (tpulc)                              |
|--------|---------------------------|-----------------------------------------------|
| K1     | `mtf_recency`             | `mtf_pallas.py:mtf_recency_pallas`            |
| K2     | `mtf_encode_lockstep`     | `mtf_pallas.py:mtf_encode_lockstep_pallas`    |
| K4     | `mtf_lockstep`            | `mtf_pallas.py:mtf_lockstep_pallas`           |

A wrapper given a CPU tensor runs the plain PyTorch version; given a
CUDA tensor it launches the kernel (and adds one to its `launches`
count) or raises — it never falls back.  The `*_plain` functions are
device-agnostic torch code: the CPU tests hold them against tpulc, and
`chip_smoke.py` holds each kernel against its plain version on the
card.
"""

from __future__ import annotations

import torch

from tpulc_torch import cuda_lib

ALPHA = 256


def _route(*tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _check_i32(name: str, t: torch.Tensor, ndim: int, width: int | None):
    if t.dtype != torch.int32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: need contiguous int32 with {ndim} dims, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if width is not None and t.shape[-1] != width:
        raise ValueError(f"{name}: last dim must be {width}")


def _check_walk(table0: torch.Tensor, seq: torch.Tensor) -> None:
    _check_i32("table0", table0, 2, ALPHA)
    _check_i32("seq", seq, 2, None)
    if table0.shape[0] != seq.shape[0]:
        raise ValueError("table0 and seq disagree on the chunk count")


def _move_to_front(table, rank, value):
    """table [B,256]; move position `rank` (holding `value`) to front."""
    pos = torch.arange(table.shape[1], device=table.device)[None, :]
    shifted = torch.cat([value[:, None], table[:, :-1]], dim=1)
    return torch.where(pos <= rank[:, None], shifted, table)


# --------------------------------------------------------------- K1

def mtf_recency_plain(syms: torch.Tensor) -> torch.Tensor:
    """int32[nchunks, C] -> int32[nchunks, 256]: last step index of each
    symbol in its chunk, -1 when absent (symbols outside [0,256) are
    ignored)."""
    nchunks, C = syms.shape
    s = syms.long()
    s = torch.where((s >= 0) & (s < ALPHA), s, ALPHA)
    step = torch.arange(C, device=syms.device, dtype=torch.int32)
    out = torch.full((nchunks, ALPHA + 1), -1, dtype=torch.int32,
                     device=syms.device)
    out.scatter_reduce_(1, s, step.expand(nchunks, C), "amax")
    return out[:, :ALPHA].contiguous()


def mtf_recency(syms: torch.Tensor) -> torch.Tensor:
    """K1 wrapper (see `mtf_recency_plain`)."""
    _check_i32("syms", syms, 2, None)
    if _route(syms) == "cpu":
        return mtf_recency_plain(syms)
    lib = cuda_lib.library()
    nchunks, C = syms.shape
    out = torch.empty((nchunks, ALPHA), dtype=torch.int32, device=syms.device)
    with torch.cuda.device(syms.device):
        cuda_lib.check(lib.tplc_mtf_recency(
            syms.data_ptr(), out.data_ptr(), nchunks, C,
            cuda_lib.stream_of(syms)), "mtf_recency")
    mtf_recency.launches += 1
    return out


mtf_recency.launches = 0


# --------------------------------------------------------------- K2

def mtf_encode_lockstep_plain(table0: torch.Tensor, syms: torch.Tensor):
    """Lockstep MTF-by-symbol: table0 int32[nchunks,256], syms
    int32[nchunks,C] -> (ranks int32[nchunks,C], final table).  A
    symbol's rank is its first position in the table (0 when absent)."""
    table = table0
    ranks = []
    for t in range(syms.shape[1]):
        col = syms[:, t]
        rank = torch.argmax((table == col[:, None]).to(torch.int32), dim=1)
        table = _move_to_front(table, rank, col)
        ranks.append(rank.to(torch.int32))
    out = torch.stack(ranks, dim=1) if ranks else syms.clone()
    return out.contiguous(), table.contiguous()


def mtf_encode_lockstep(table0: torch.Tensor, syms: torch.Tensor):
    """K2 wrapper (see `mtf_encode_lockstep_plain`)."""
    _check_walk(table0, syms)
    if _route(table0, syms) == "cpu":
        return mtf_encode_lockstep_plain(table0, syms)
    lib = cuda_lib.library()
    nchunks, C = syms.shape
    ranks = torch.empty_like(syms)
    tab = torch.empty_like(table0)
    with torch.cuda.device(syms.device):
        cuda_lib.check(lib.tplc_mtf_encode_lockstep(
            table0.data_ptr(), syms.data_ptr(), ranks.data_ptr(),
            tab.data_ptr(), nchunks, C, cuda_lib.stream_of(syms)),
            "mtf_encode_lockstep")
    mtf_encode_lockstep.launches += 1
    return ranks, tab


mtf_encode_lockstep.launches = 0


# --------------------------------------------------------------- K4

LANES = (32, 16, 8)   # K4: lanes a chunk the kernel is built for


def mtf_lockstep_plain(table0: torch.Tensor | None, ranks: torch.Tensor,
                       want_syms: bool = True, want_table: bool = True):
    """Lockstep MTF-by-rank: table0 int32[nchunks,256] (None: every
    chunk starts from the identity), ranks int32[nchunks,C] (clamped to
    [0,255]) -> (symbols int32[nchunks,C], final table); an output that
    is not wanted is None.  Table entries are moved, never inspected:
    any int32 values, a permutation or not."""
    nchunks = ranks.shape[0]
    if table0 is None:
        table0 = torch.arange(ALPHA, device=ranks.device,
                              dtype=torch.int32).expand(nchunks, ALPHA)
    table = table0
    syms = []
    for t in range(ranks.shape[1]):
        rank = ranks[:, t].clamp(0, ALPHA - 1).long()
        sym = table.gather(1, rank[:, None])[:, 0]
        table = _move_to_front(table, rank, sym)
        syms.append(sym)
    out = torch.stack(syms, dim=1) if syms else ranks.clone()
    return (out.contiguous() if want_syms else None,
            table.contiguous() if want_table else None)


def mtf_lockstep(table0: torch.Tensor | None, ranks: torch.Tensor,
                 want_syms: bool = True, want_table: bool = True,
                 lanes: int | None = None):
    """K4 wrapper (see `mtf_lockstep_plain`).  `lanes` (one of LANES)
    picks a build of the kernel; None leaves the choice to the C entry
    point.  It changes no output."""
    if table0 is None:
        _check_i32("ranks", ranks, 2, None)
    else:
        _check_walk(table0, ranks)
    if lanes is not None and lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}")
    tensors = (ranks,) if table0 is None else (table0, ranks)
    if _route(*tensors) == "cpu":
        return mtf_lockstep_plain(table0, ranks, want_syms, want_table)
    lib = cuda_lib.library()
    nchunks, C = ranks.shape
    dev = ranks.device
    syms = torch.empty_like(ranks) if want_syms else None
    tab = torch.empty((nchunks, ALPHA), dtype=torch.int32,
                      device=dev) if want_table else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        cuda_lib.check(lib.tplc_mtf_lockstep(
            ptr(table0), ranks.data_ptr(), ptr(syms), ptr(tab), nchunks, C,
            lanes or 0, cuda_lib.stream_of(ranks)), "mtf_lockstep")
    mtf_lockstep.launches += 1
    return syms, tab


mtf_lockstep.launches = 0

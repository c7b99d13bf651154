"""The anchored inverse-BWT lane walk: wrapper, launch count and plain
version, shared by `rotsort.bwt_decode_anchored` and
`masked.bwt_decode_masked_anchored`.

tpulc runs the walk as one `jax.lax.fori_loop` over all lanes under XLA,
with no `pallas_call` (`tpulc/codecs/bwt/rotsort.py:375`,
`tpulc/codecs/bwt/masked.py:235`).  On the card it was a Python loop of
S gathers and row copies, so it is a hand kernel here: the CUDA source
is `tpulc_torch/csrc/ibwt.cu` (design notes there).

`anchored_walk(T, last, anchors, n, S, cap)` -> uint8[cap]: lane j
(j * S < n) starts at row anchors[j] and takes min(S, n - j*S) LF steps
p -> T[p], writing last[p] at each step; output position n-1-i holds
lane i // S at step i % S, and positions n..cap-1 are 0.  T is the
stable LF map int32[cap] of last[:n] (each caller's own `_lf_map`:
T[p] = C[last[p]] + occ(last[p], p) for p < n, with C the cumulative
byte counts of last[:n]), last uint8[cap], anchors int32 or int64 with
at least ceil(n / S) entries.

The anchor contract: a row p >= n has no byte in C, so a lane whose
anchor lies outside [0, n) (a corrupt payload; a padding row of a
masked block) reads nothing and writes zeros over its run, in the
kernel and in the plain version alike.  The decoders never pass one:
bz has cap == n, and bsc refuses such anchors before the walk.

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the kernel (and adds one to its `launches` count)
or raises — it never falls back.
"""

from __future__ import annotations

import torch

from tpulc_torch import cuda_lib


def _check(T, last, anchors, n: int, S: int, cap: int) -> int:
    """-> the number of lanes that write, ceil(n / S); raises ValueError."""
    cuda_lib.check_tensor("T", T, torch.int32, (cap,))
    cuda_lib.check_tensor("last", last, torch.uint8, (cap,))
    if anchors.dim() != 1 or anchors.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"anchors: need 1-D int32 or int64, got "
                         f"{anchors.dtype} {tuple(anchors.shape)}")
    if S < 1 or not 0 <= n <= cap or cap >= 1 << 31:
        raise ValueError(f"need S >= 1 and 0 <= n <= cap < 2^31 "
                         f"(n {n}, S {S}, cap {cap})")
    lanes = -(-n // S)
    if anchors.shape[0] < lanes:
        raise ValueError(f"{anchors.shape[0]} anchors for {lanes} lanes")
    cuda_lib.device_of(T, last, anchors)
    return lanes


def anchored_walk_plain(T, last, anchors, n: int, S: int, cap: int):
    """The walk as S steps of one gather over every lane (see the module
    docstring)."""
    lanes = -(-n // S)
    # (T, last) ride one int64 so each serial step is a single gather
    TL = T.to(torch.int64) | (last.to(torch.int64) << 32)
    out = torch.empty((S, lanes), dtype=torch.int64, device=last.device)
    a = anchors[:lanes].to(torch.int64)
    bad = (a < 0) | (a >= n)
    p = torch.where(bad, 0, a)
    for t in range(S):
        e = TL[p]
        out[t] = e
        p = e & 0xFFFFFFFF
    out[:, bad] = 0
    flat = (out >> 32).to(torch.uint8).T.reshape(-1)   # lane-major steps
    # flat[i] belongs at n-1-i; the last lane's steps past n fall off
    return torch.cat([torch.flip(flat[:n], (0,)),
                      torch.zeros(cap - n, dtype=torch.uint8,
                                  device=last.device)])


def anchored_walk(T, last, anchors, n: int, S: int, cap: int):
    """Kernel wrapper (see `anchored_walk_plain`).  The kernel picks its
    lanes a warp from the lanes and the card's SM count."""
    lanes = _check(T, last, anchors, n, S, cap)
    if T.device.type == "cpu":
        return anchored_walk_plain(T, last, anchors, n, S, cap)
    if lanes == 0:   # nothing to launch
        return torch.zeros(cap, dtype=torch.uint8, device=T.device)
    out = torch.empty(cap, dtype=torch.uint8, device=T.device)
    counts = torch.empty(256, dtype=torch.int32, device=T.device)
    a = anchors[:lanes].contiguous()   # read at its own width
    lib = cuda_lib.library()
    with torch.cuda.device(T.device):
        # counts last[:n], writes out[n:] zeros, walks
        cuda_lib.check(lib.tplc_anchored_walk(
            T.data_ptr(), last.data_ptr(), counts.data_ptr(), a.data_ptr(),
            a.element_size(), out.data_ptr(), n, S, cap, lanes, 0,
            cuda_lib.stream_of(T)), "anchored_walk")
    anchored_walk.launches += 1
    return out


anchored_walk.launches = 0

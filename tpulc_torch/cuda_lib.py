"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled with nvcc for `sm_90a` into its own
shared library with a plain C interface and loaded with ctypes (no
PyTorch headers: a build takes seconds, not minutes).  The nvcc runs
for all sources start together, so the build takes as long as the
slowest file.  It runs at first use, never at import, into
`tpulc_torch/_build/` (git-ignored); each library is named by a hash of
its source, the headers and the flags, so an edited source rebuilds.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check()` raises on anything but 0, because a
refused launch never runs and a later synchronize does not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import types

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types (pointers and the stream as void*)
_SIGNATURES = {
    "tplc_mtf_recency": [_P, _P, _P, _I, _I, _I, _P],
    "tplc_mtf_encode_lockstep": [_P, _P, _P, _P, _I, _I, _P],
    "tplc_mtf_start_tile": [_I, _I],
    "tplc_mtf_start_tables": [_P, _P, _P, _P, _I, _I, _I, _P],
    "tplc_mtf_lockstep": [_P, _P, _P, _P, _I, _I, _I, _P],
    "tplc_huffman_walk": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I,
                          _I, _I, _I, _P],
    "tplc_huffman_walk_v1": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P,
                             _I, _I, _P],
    "tplc_huffman_walk_flat": [_P, _I, _I, _P, _P, _I, _P, _P, _P, _I, _I,
                               _P],
    "tplc_grc_walk_probs": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tplc_grc_reverse_rans": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tplc_grc_reverse_rans_route": [_I],
    "tplc_grc_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "tplc_rans_encode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tplc_rans_encode_lanes": [_I, _I, _I, _I],
    "tplc_rans_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tplc_rans_decode_lanes": [_I, _I, _I],
    "tplc_abc_encode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tplc_abc_encode_lanes": [_I],
    "tplc_abc_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tplc_running_scan_scratch": [_I],
    "tplc_running_scan_tile": [_I],
    "tplc_running_scan": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tplc_anchored_walk_lanes": [_I],
    "tplc_anchored_walk": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "tplc_culzss_match": [_P, _P, _P, _I, _P],
}

_lib: types.SimpleNamespace | None = None
# source file name -> nvcc's output of the last build (ptxas registers,
# shared memory and spills per kernel); empty for a library found built
build_log: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> tuple[list[str], list[str]]:
    names = sorted(os.listdir(_CSRC))
    return ([os.path.join(_CSRC, f) for f in names if f.endswith(".cu")],
            [os.path.join(_CSRC, f) for f in names if f.endswith(".cuh")])


def _so_path(src: str, headers: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [src, *headers]:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(_BUILD, f"lib{stem}_{h.hexdigest()[:16]}.so")


def library() -> types.SimpleNamespace:
    """The C entry points of every kernel library, building on first use."""
    global _lib
    if _lib is not None:
        return _lib
    srcs, headers = _sources()
    os.makedirs(_BUILD, exist_ok=True)
    sos = [_so_path(s, headers) for s in srcs]
    jobs = []
    try:
        for src, so in zip(srcs, sos):
            if os.path.exists(so):
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            jobs.append((src, so, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for src, so, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{os.path.basename(src)} "
                              f"({proc.returncode}):\n{log}")
            else:
                build_log[os.path.basename(src)] = log
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    fns = {}
    for so in sos:
        dll = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            if name in fns or not hasattr(dll, name):
                continue
            fn = getattr(dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    missing = sorted(set(_SIGNATURES) - set(fns))
    if missing:
        raise RuntimeError(f"kernel entry points not found: {missing}")
    _lib = types.SimpleNamespace(**fns)
    return _lib


def stream_of(t) -> int:
    """Raw cudaStream_t of PyTorch's current stream on t's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(name: str, t, dtype, shape) -> None:
    """A wrapper's argument check: t contiguous, of dtype, with shape
    (None matches any size); raises ValueError."""
    if t.dtype != dtype or not t.is_contiguous() or t.dim() != len(shape) \
            or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: need contiguous {dtype} of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def device_of(*tensors):
    """The one device of a wrapper's tensors, "cpu" or "cuda"; raises
    ValueError for several devices or another kind."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}")

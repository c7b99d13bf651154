"""The hybrid inverse ST-k's host walk: a ctypes wrapper over
`st_inverse.c`, a copy of tpulc's `st_gold_inverse`
(`tpulc/gold/csrc/bzip2_stream.c:323-365`).

`st_inverse.c` is built at first use by `gold/build.py` (`cc`, into
`tpulc_torch/_build/`); without a C compiler the first call raises:
there is no fallback.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tpulc_torch.gold.build import load

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "st_inverse.c")

_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = load(_SRC)
    lib.st_gold_inverse.restype = ctypes.c_long
    lib.st_gold_inverse.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_int, ctypes.c_void_p]
    _lib = lib
    return lib


def st_inverse(last: np.ndarray, hi: np.ndarray, lo: np.ndarray, idx0: int,
               k: int) -> np.ndarray:
    """The text of n = len(last) bytes from the ST-k last column, its
    slots' context keys (hi, lo uint32[n], sorted, from
    `stk.st_context_keys`) and the primary index.  Raises ValueError
    when idx0 is not a row of `last` (the walk would read past it) or
    when the walk finds no slot for a step.  Each call adds one to
    `st_inverse.launches`."""
    n = last.shape[0]
    if hi.shape != (n,) or lo.shape != (n,):
        raise ValueError("st_inverse: keys and last column differ in length")
    if n and not 0 <= idx0 < n:
        raise ValueError(f"bad ST payload: idx0 {idx0} not in [0, {n})")
    last = np.ascontiguousarray(last, np.uint8)
    hi = np.ascontiguousarray(hi, np.uint32)
    lo = np.ascontiguousarray(lo, np.uint32)
    out = np.zeros(n, np.uint8)
    st_inverse.launches += 1
    r = _load().st_gold_inverse(last.ctypes.data, n, hi.ctypes.data,
                                lo.ctypes.data, idx0, k, out.ctypes.data)
    if r < 0:
        raise ValueError("bad ST payload: the inverse walk failed")
    return out


st_inverse.launches = 0

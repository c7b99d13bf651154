"""The host LZP stage of the bsc codec: a ctypes wrapper over `lzp.c`,
a copy of `tpulc/gold/csrc/lzp.c` (same wire format, same bytes).

`lzp.c` is built at first use by `gold/build.py` (`cc`, into
`tpulc_torch/_build/`); without a C compiler the first call raises:
there is no fallback.  Importing this module builds nothing.

While the stage timer is on, each encode adds its counters to the
timer's totals (`COUNTERS`): its steps, its predicted steps (the
context table had an entry), the steps it compared (their fingerprints
agreed) and its matches.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tpulc_torch.gold.build import load
from tpulc_torch.utils import timing

DEFAULT_HASH_BITS = 18
DEFAULT_MIN_LEN = 32
COUNTERS = ("#lzp_steps", "#lzp_predicted", "#lzp_checked", "#lzp_matches")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lzp.c")

_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = load(_SRC)
    args = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int]
    for name, extra in (("lzp_gold_encode", [ctypes.c_void_p]),
                        ("lzp_gold_decode", [])):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = args + extra
    _lib = lib
    return lib


def _as_array(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(data, np.uint8)
    return np.ascontiguousarray(data, np.uint8)


def lzp_encode(data: bytes | np.ndarray, hash_bits: int = DEFAULT_HASH_BITS,
               min_len: int = DEFAULT_MIN_LEN) -> bytes | None:
    """The LZP stream, or None when it would not shrink the data."""
    arr = _as_array(data)
    if arr.size < 64:
        return None
    out = np.zeros(arr.size, np.uint8)  # only actual shrinkage is kept
    counts = np.zeros(len(COUNTERS), np.int64) if timing.counting() else None
    n = _load().lzp_gold_encode(
        arr.ctypes.data, arr.size, out.ctypes.data, arr.size, hash_bits,
        min_len, None if counts is None else counts.ctypes.data)
    if counts is not None:
        timing.add_totals(COUNTERS, counts.tolist())
    if n < 0 or n >= arr.size:
        return None
    return out[:n].tobytes()


def lzp_decode(data: bytes | np.ndarray, out_cap: int,
               hash_bits: int = DEFAULT_HASH_BITS,
               min_len: int = DEFAULT_MIN_LEN) -> bytes:
    arr = _as_array(data)
    out = np.zeros(max(out_cap, 1), np.uint8)
    n = _load().lzp_gold_decode(arr.ctypes.data, arr.size, out.ctypes.data,
                                out_cap, hash_bits, min_len)
    if n < 0:
        raise ValueError("invalid LZP stream")
    return out[:n].tobytes()

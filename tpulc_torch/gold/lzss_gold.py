"""The Dipperstein lzss-0.6.2 codec on the host: a ctypes wrapper over
`lzss_gold.c`, a copy of tpulc's C gold (`tpulc/gold/csrc/lzss_gold.c`,
bound by `tpulc/gold/lzss_gold.py:lzss_encode`, `lzss_decode`).

It is the bit-exact stand-in for the reference encoder and an
independent oracle for the device codec (`codecs/lzss`).
`lzss_gold.c` is built at first use by `gold/build.py` (`cc`, into
`tpulc_torch/_build/`); without a C compiler the first call raises:
there is no fallback.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tpulc_torch.gold.build import load

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "lzss_gold.c")

_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = load(_SRC)
    for fn in (lib.lzss_gold_encode, lib.lzss_gold_decode):
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                       ctypes.c_long]
    _lib = lib
    return lib


def _as_array(data: bytes | np.ndarray) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(data, np.uint8)
    return np.ascontiguousarray(data, np.uint8)


def lzss_encode(data: bytes | np.ndarray) -> bytes:
    """The reference encoder's bitstream of `data` (brute-force
    first-longest matches over the 4,096-byte ring)."""
    arr = _as_array(data)
    cap = 2 * max(arr.shape[0], 64) + 64
    out = np.zeros(cap, np.uint8)
    n = _load().lzss_gold_encode(arr.ctypes.data, arr.shape[0],
                                 out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("gold lzss encode overflow")
    return out[:n].tobytes()


def lzss_decode(data: bytes | np.ndarray, out_cap: int) -> bytes:
    """Decode a bitstream of at most `out_cap` bytes; RuntimeError when
    it decodes to more."""
    arr = _as_array(data)
    out = np.zeros(max(out_cap, 1), np.uint8)
    n = _load().lzss_gold_decode(arr.ctypes.data, arr.shape[0],
                                 out.ctypes.data, out_cap)
    if n < 0:
        raise RuntimeError("gold lzss decode overflow")
    return out[:n].tobytes()

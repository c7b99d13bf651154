"""The .bz2 decoder on the host: a ctypes wrapper over
`bzip2_stream.c`, a copy of tpulc's `bz2_gold_decompress`
(`tpulc/gold/csrc/bzip2_stream.c:18-321`, bound by
`tpulc/gold/lzss_gold.py:bz2_decompress`).

`bzip2_stream.c` is built at first use by `gold/build.py` (`cc`, into
`tpulc_torch/_build/`); without a C compiler the first call raises:
there is no fallback.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tpulc_torch.gold.build import load

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "bzip2_stream.c")

_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = load(_SRC)
    lib.bz2_gold_decompress.restype = ctypes.c_long
    lib.bz2_gold_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
    _lib = lib
    return lib


def bz2_decompress(data: bytes, out_cap: int) -> bytes:
    """Decode a .bz2 stream of at most `out_cap` bytes.  Raises
    BufferError when the output needs more than `out_cap` (the
    decoder's -2), ValueError on a block or combined CRC mismatch (-3)
    and on any other malformed stream."""
    arr = np.frombuffer(data, np.uint8)
    out = np.empty(max(out_cap, 1), np.uint8)
    n = _load().bz2_gold_decompress(arr.ctypes.data, arr.shape[0],
                                    out.ctypes.data, out_cap)
    if n == -2:
        raise BufferError("bz2 output buffer too small")
    if n == -3:
        raise ValueError("bz2 CRC mismatch (corrupt stream)")
    if n < 0:
        raise ValueError("invalid .bz2 stream")
    return out[:n].tobytes()

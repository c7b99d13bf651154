"""The host LZP stage of the bsc codec: a ctypes wrapper over `lzp.c`,
a copy of `tpulc/gold/csrc/lzp.c` (same wire format, same bytes).

`lzp.c` is compiled with `cc -O2 -fPIC -shared` at first use into
`tpulc_torch/_build/`, named by a hash of the source and the flags, so
an edited source rebuilds.  Without a C compiler the first call raises:
there is no fallback.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

DEFAULT_HASH_BITS = 18
DEFAULT_MIN_LEN = 32

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "gold", "lzp.c")
_BUILD = os.path.join(_PKG, "_build")
CC_FLAGS = ["-O2", "-fPIC", "-shared"]

_lib: ctypes.CDLL | None = None


def _so_path() -> str:
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD, f"liblzp_{h.hexdigest()[:16]}.so")


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    so = _so_path()
    if not os.path.exists(so):
        cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
        if not cc:
            raise RuntimeError("no C compiler (cc) to build the LZP library")
        os.makedirs(_BUILD, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        try:
            r = subprocess.run([cc, *CC_FLAGS, "-o", tmp, _SRC],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"cc failed on lzp.c:\n{r.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(so)
    for name in ("lzp_gold_encode", "lzp_gold_decode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                       ctypes.c_long, ctypes.c_int, ctypes.c_int]
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
    n = _load().lzp_gold_encode(arr.ctypes.data, arr.size, out.ctypes.data,
                                arr.size, hash_bits, min_len)
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

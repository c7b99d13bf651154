"""Build a host C source of `tpulc_torch/gold/` into a shared library.

The source is compiled with `cc -O2 -fPIC -shared` at first use into
`tpulc_torch/_build/`, named by a hash of the source and the flags, so
an edited source rebuilds.  Without a C compiler the call raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD = os.path.join(_PKG, "_build")
CC_FLAGS = ["-O2", "-fPIC", "-shared"]


def so_path(src: str) -> str:
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(_BUILD, f"lib{stem}_{h.hexdigest()[:16]}.so")


def load(src: str) -> ctypes.CDLL:
    """The C source at path `src`, built and loaded."""
    name = os.path.basename(src)
    so = so_path(src)
    if not os.path.exists(so):
        cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
        if not cc:
            raise RuntimeError(f"no C compiler (cc) to build {name}")
        os.makedirs(_BUILD, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        try:
            r = subprocess.run([cc, *CC_FLAGS, "-o", tmp, src],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"cc failed on {name}:\n{r.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(so)

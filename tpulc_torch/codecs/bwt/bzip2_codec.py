"""The `bzip2` codec: writes and reads real .bz2 files, no tpulc
container (port of `tpulc/codecs/bwt/bzip2_codec.py`).

Compression is the bit-exact emitter of `bz2stream`, its transforms on
the card.  Decompression is the C decoder of `gold/bzip2_stream.c` on
the host, and runs no device code, as in tpulc and in the reference
(cuda-bzip2 decompresses on the CPU, README.md:82-84).
"""

from __future__ import annotations

import numpy as np
import torch

from tpulc_torch.codecs.bwt.bz2stream import bz2_compress
from tpulc_torch.device import resolve
from tpulc_torch.gold.bzip2 import bz2_decompress
from tpulc_torch.utils import timing


def compress(data: bytes | np.ndarray, block_size: int = 900_000,
             level: int | None = None,
             device: str | torch.device | None = None) -> bytes:
    """A .bz2 stream; `level` defaults to block_size // 100,000 clamped
    to 1..9 (the CLI's 1 MiB blocks give level 9)."""
    if level is None:
        level = max(1, min(9, block_size // 100_000))
    return bz2_compress(data, level, device)


def decompress(buf: bytes,
               device: str | torch.device | None = None) -> bytes:
    """Decode a .bz2 stream on the host, sizing the output from the
    stream itself.  `device` is checked like every entry point's (CUDA
    asked for and absent raises) and is otherwise unused.

    The header `BZh<level>` bounds each block at level*100k bytes before
    inverse RLE1, whose expansion (5 coded bytes -> up to 259) has no
    fixed ratio to the compressed size: start from one block's bound and
    double on the decoder's buffer-too-small signal."""
    resolve(device)
    if len(buf) < 4 or buf[:3] != b"BZh" or not 0x31 <= buf[3] <= 0x39:
        raise ValueError("invalid .bz2 stream")
    level = buf[3] - 0x30
    out_cap = max(64 * len(buf), 52 * 100_000 * level)
    with timing.stage("bzip2.decode"):
        while True:
            try:
                return bz2_decompress(buf, out_cap)
            except BufferError:
                out_cap *= 2

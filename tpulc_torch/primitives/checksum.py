"""Host checksums, copied from `tpulc/primitives/checksum.py`:
`adler32_np` (libbsc block integrity) and `crc32_bzip2_np` (bzip2's
MSB-first CRC32).

libbsc stores adler32 of the data, of the compressed payload, and of
the header in every block header (`libbsc/libbsc/libbsc.cpp:211-219`);
the container does the same.  bzip2 streams carry a per-block and a
combined CRC32 (MSB-first variant) that the .bz2 emitter must
reproduce.
"""

from __future__ import annotations

import zlib

import numpy as np

_BITREV8 = np.array(
    [int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8
)


def adler32_np(data: bytes | np.ndarray, value: int = 1) -> int:
    """Host adler32 (zlib-compatible) of any buffer: a C-contiguous
    ndarray is read in place, any other is made contiguous first."""
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data)
    return zlib.adler32(data, value) & 0xFFFFFFFF


def crc32_bzip2_np(data: bytes | np.ndarray) -> int:
    """bzip2's CRC32 of a whole buffer (init/xorout 0xFFFFFFFF applied).

    The MSB-first CRC equals the bit-reversed reflected CRC of
    bit-reversed bytes, so zlib's crc32 does the work.
    """
    arr = np.frombuffer(data, np.uint8) if isinstance(data, bytes) else data
    refl = zlib.crc32(_BITREV8[arr].tobytes()) & 0xFFFFFFFF
    return int(f"{refl:032b}"[::-1], 2)

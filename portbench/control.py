"""The benchmark's control and planted faults: one run of a cell with a
broken codec in the program's place, which the comparison must judge
not correct.

    python3 -m portbench.control --workload <cell> --seed <n> --seconds <s> --fault <name>

Faults (each breaks the configuration's lossless guarantee the way a
faster but wrong codec would, with every checksum of the container
still valid):

- `lossy` (the control): compress is given the object with one byte
  changed, at a position drawn from the seed;
- `flip_container`: one byte of the last payload's tail is flipped where
  compress writes it, and the payload's adler32 is written anew;
- `flip_output`: one byte of what decompress returns is flipped;
- `half_input`: compress is given the first half of the object;
- `half_output`: decompress returns the first half of its bytes.

The benchmark's own runs never load this module.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import zlib

import numpy as np

from portbench import run

FAULTS = ("lossy", "flip_container", "flip_output", "half_input",
          "half_output")


class Faulty:
    """A codec with one fault planted in it."""

    def __init__(self, codec, fault: str, seed: int):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r} ({', '.join(FAULTS)})")
        self.codec, self.fault = codec, fault
        self.rng = np.random.default_rng(seed)

    def compress(self, obj, **kw):
        if self.fault == "lossy":
            obj = obj.copy()
            obj[int(self.rng.integers(obj.shape[0]))] ^= 0x20
        elif self.fault == "half_input":
            obj = obj[: obj.shape[0] // 2]
        c = self.codec.compress(obj, **kw)
        if self.fault == "flip_container":
            c = flip_payload_byte(c)
        return c

    def decompress(self, container, **kw):
        d = self.codec.decompress(container, **kw)
        if self.fault == "flip_output":
            b = bytearray(d)
            b[int(self.rng.integers(len(b)))] ^= 0x20
            d = bytes(b)
        elif self.fault == "half_output":
            d = d[: len(d) // 2]
        return d


def flip_payload_byte(c: bytes) -> bytes:
    """Flip a byte 8 bytes before the end of the last payload and write
    its adler32 anew (the container's table of payload checksums)."""
    (nblocks,) = struct.unpack_from("<I", c, 20)
    sizes = np.frombuffer(c, "<u4", nblocks, 32)
    last = len(c) - int(sizes[-1])
    b = bytearray(c)
    b[len(b) - 8] ^= 0x5A
    adler = zlib.adler32(bytes(b[last:])) & 0xFFFFFFFF
    struct.pack_into("<I", b, 32 + 4 * nblocks + 4 * (nblocks - 1), adler)
    return bytes(b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=FAULTS, default="lossy")
    a = ap.parse_args(argv)
    code, result = run.run_cell(
        a.workload, a.seed, a.seconds, 0,
        codec_wrap=lambda c: Faulty(c, a.fault, a.seed))
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())

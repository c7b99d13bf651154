"""The benchmark's plain decoder of the huffman container
(`portbench/reference/huffman.py`) against the port's containers on the
CPU: seeded inputs at small sizes, both chunk tables, and containers
broken so that every checksum still holds."""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from portbench import control
from portbench.reference import huffman as ref
from portbench.reference.common import FormatError
from tpulc_torch.codecs.huffman.tables import HuffmanTable
from tpulc_torch.pipeline.registry import get_codec

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "data", "pg1661.txt"), "rb") as _f:
    PG = _f.read()


def words(n: int, seed: int) -> bytes:
    """n bytes of pg1661's lines in a seeded order."""
    lines = PG.splitlines(keepends=True)
    rng = np.random.default_rng(seed)
    out = b"".join(lines[i] for i in rng.integers(len(lines), size=n // 20))
    return (out * (n // max(1, len(out)) + 1))[:n]


def fibonacci_skew(seed: int) -> bytes:
    """Symbol i drawn fib(i) times: an unlimited code would be 19 deep."""
    fib = [1, 1]
    while len(fib) < 20:
        fib.append(fib[-1] + fib[-2])
    syms = np.repeat(np.arange(20, dtype=np.uint8) * 7, fib)
    return np.random.default_rng(seed).permutation(syms).tobytes()


RNG = np.random.default_rng(23)
CASES = {
    "empty": (b"", {}),
    "one_byte": (b"a", {}),
    "one_symbol_blocks": (b"z" * 50_000, {"block_size": 16_384}),
    "all_256": (RNG.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
                {"block_size": 32_768}),
    "skew_at_12_bits": (fibonacci_skew(1) * 3, {"block_size": 32_768}),
    "skew_at_15_bits": (fibonacci_skew(2), {"block_size": 32_768,
                                            "max_len": 15}),
    "two_blocks": (words((1 << 20) + 1, 3), {}),
    "v1_table": (words(150_000, 4), {"block_size": 65_536,
                                     "chunk_syms": 256}),
    "v2_table": (words(150_000, 5), {"block_size": 65_536}),
    "v2_chunks_of_32": (words(90_000, 6), {"block_size": 40_000,
                                           "chunk_syms": 32}),
    "two_groups": (words(140_000, 7), {"block_size": 1_024}),
}


def payloads_of(c: bytes):
    (n,) = struct.unpack_from("<I", c, 20)
    sizes = np.frombuffer(c, "<u4", n, 32)
    off = 32 + 8 * n
    out = []
    for s in sizes:
        out.append(bytearray(c[off: off + int(s)]))
        off += int(s)
    return out


def reseal(c: bytes, payloads) -> bytes:
    """The container with these payloads and their sizes and adler32s
    written anew (the header, n and the data adler32 kept)."""
    sizes = np.array([len(p) for p in payloads], "<u4").tobytes()
    adlers = np.array([zlib.adler32(bytes(p)) & 0xFFFFFFFF
                       for p in payloads], "<u4").tobytes()
    return c[:32] + sizes + adlers + b"".join(bytes(p) for p in payloads)


def compress(data: bytes, **kw) -> bytes:
    return get_codec("huffman").compress(data, device="cpu", **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reads_the_port(case):
    data, kw = CASES[case]
    c = compress(data, **kw)
    assert ref.decode(c) == data
    port = get_codec("huffman").decompress(
        c, device="cpu", **({"max_len": kw["max_len"]} if "max_len" in kw
                            else {}))
    assert port == data
    p = payloads_of(c)[0]
    if case.startswith("skew_at_"):
        nib = np.frombuffer(bytes(p[9:137]), np.uint8)
        assert max(int((nib & 15).max()), int((nib >> 4).max())) == \
            kw.get("max_len", 12)
    if case.startswith(("v1", "v2")):
        assert p[8] == (1 if kw.get("chunk_syms") == 256 else 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_code_table_is_the_canonical_code(seed):
    """The reference's 15-bit windows against the port's 12-bit decode
    table of the same lengths."""
    rng = np.random.default_rng(seed)
    freqs = np.zeros(256, np.int64)
    freqs[rng.choice(256, 40 + 60 * seed, replace=False)] = \
        rng.integers(1, 10_000, 40 + 60 * seed)
    t = HuffmanTable.from_freqs(freqs, 12)
    sym, ln = ref.code_table(np.asarray(t.lengths, np.int64))
    assert np.array_equal(sym[::8], t.lut_sym)
    assert np.array_equal(ln[::8], t.lut_len)


def _v2_deltas(p):
    nchunks = struct.unpack_from("<I", p, 138)[0]
    return np.frombuffer(bytes(p[142: 142 + 2 * nchunks]), "<u2").copy()


def _break(fault: str) -> bytes:
    data = words(100_000, 8)
    v1 = fault.startswith("v1")
    c = compress(data, block_size=65_536, **({"chunk_syms": 256} if v1
                                             else {}))
    ps = payloads_of(c)
    p = ps[0]
    n, tb, _ = struct.unpack_from("<IIB", p)
    if fault == "v2_delta_off_by_one_bit":
        d = _v2_deltas(p)
        d[0] += 1
        d[1] -= 1
        p[142: 142 + 2 * d.shape[0]] = d.tobytes()
    elif fault == "last_chunk_one_bit_long":
        # a zero bit after the last code: every symbol decodes right,
        # and only the chunk's end tells
        d = _v2_deltas(p)
        d[-1] += 1
        p[142: 142 + 2 * d.shape[0]] = d.tobytes()
        struct.pack_into("<I", p, 4, tb + 1)
        if tb % 32 == 0:
            p += bytes(4)
    elif fault == "v1_offset_off_by_one_bit":
        off = np.frombuffer(bytes(p[141: 141 + 8]), "<u4").copy()
        off[1] += 1
        p[141: 149] = off.tobytes()
    elif fault == "truncated_words":
        del p[-4:]
    elif fault == "n_one_short":
        struct.pack_into("<I", p, 0, n - 1)
    elif fault == "n_a_chunk_short":
        struct.pack_into("<I", p, 0, n - 200)
    elif fault == "total_bits_one_long":
        struct.pack_into("<I", p, 4, tb + 1)
    elif fault == "lengths_over_kraft":
        nib = np.frombuffer(bytes(p[9:137]), np.uint8)
        lens = np.stack([nib & 15, nib >> 4], 1).reshape(-1)
        s = int(np.flatnonzero(lens == lens.max())[0])
        lens[s] -= 1
        p[9:137] = (lens[0::2] | lens[1::2] << 4).astype(np.uint8).tobytes()
    elif fault == "no_chunk_table":
        return compress(data, block_size=65_536, aligned=False)
    elif fault == "sizes_do_not_add_up":
        return c[:-1]
    elif fault == "payload_adler32":
        b = bytearray(c)
        b[-3] ^= 1
        return bytes(b)
    return reseal(c, ps)


FAULTS = ["v2_delta_off_by_one_bit", "last_chunk_one_bit_long",
          "v1_offset_off_by_one_bit",
          "truncated_words", "n_one_short", "n_a_chunk_short",
          "total_bits_one_long", "lengths_over_kraft", "no_chunk_table",
          "sizes_do_not_add_up", "payload_adler32"]


@pytest.mark.parametrize("fault", FAULTS)
def test_broken_containers_are_refused(fault):
    with pytest.raises(FormatError):
        ref.decode(_break(fault))


def test_wrong_bytes_read_back_wrong():
    data = words(100_000, 9)
    lossy = np.frombuffer(data, np.uint8).copy()
    lossy[4_321] ^= 0x20
    assert ref.decode(compress(lossy, block_size=65_536)) != data
    # a code word's bit flipped, every checksum made whole again
    resealed = control.flip_payload_byte(compress(data, block_size=65_536))
    try:
        assert ref.decode(resealed) != data
    except FormatError:
        pass


def test_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.huffman; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('tpulc', 'tpulc_torch', 'jax')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr

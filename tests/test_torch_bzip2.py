"""The port's bzip2 codec (`codecs/bwt/bz2stream.py`, `bzip2_codec.py`,
`gold/bzip2.py`) against Python's `bz2` (libbzip2) and against tpulc
(`tpulc/codecs/bwt/bz2stream.py` through JAX on the CPU): the same
.bz2 bytes, the same RLE1 blocks, the same masked BWT in libbzip2's tie
order, the same CRC; and the host decoder on the port's streams,
libbzip2's, a 5 MiB run and corrupted streams.  The tpulc calls run at
level 1 or on small blocks (tpulc sorts every block at the level's
capacity)."""

import bz2

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulc.codecs.bwt.bz2stream import bz2_compress as tpulc_bz2_compress
from tpulc.codecs.bwt.bz2stream import rle1_split_blocks as tpulc_split
from tpulc.codecs.bwt.masked import bwt_encode_masked as tpulc_masked
from tpulc.primitives.checksum import crc32_bzip2_np as tpulc_crc
from tpulc.primitives.checksum import crc32_bzip2_slow
from tpulc_torch.codecs.bwt import bzip2_codec
from tpulc_torch.codecs.bwt.bz2stream import bz2_compress, rle1_split_blocks
from tpulc_torch.codecs.bwt.masked import bwt_encode_masked
from tpulc_torch.primitives.checksum import crc32_bzip2_np

torch.set_num_threads(1)


def _pg(n):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read()[:n]


CASES = {
    "x": lambda: b"x",
    "hello": lambda: b"hello world hello world hello",
    "runs": lambda: b"aaaaaaaaaabbbbbbbbcccc" * 10,
    "periodic": lambda: b"abab" * 1000,
    "bin": lambda: bytes(range(256)) * 4,
    "run1000": lambda: b"q" * 1000,
    "long-run": lambda: b"z" * 70000,
    "text": lambda: _pg(30000),
}


def _carry():
    """Three level 1 blocks; the second boundary falls inside a
    1,000-byte run (random bytes emit about one RLE1 byte each)."""
    rng = np.random.default_rng(7)
    rand = rng.integers(0, 256, size=99_970).astype(np.uint8).tobytes()
    return rand + b"q" * 1000 + rand[:99_000] + b"\x00" * 1000 + _pg(20000)


def _cpu(data, level):
    return bz2_compress(data, level, "cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_level9_equals_stdlib(name):
    data = CASES[name]()
    assert _cpu(data, 9) == bz2.compress(data, 9)


@pytest.mark.parametrize("level", [1, 5, 9])
def test_levels_equal_stdlib(level):
    data = _pg(20000) + bytes(500) + _pg(5000)
    assert _cpu(data, level) == bz2.compress(data, level)


@pytest.mark.parametrize("make", [
    lambda: (_pg(100000) + b"\x00" * 5000) * 2 + _pg(50000), _carry],
    ids=["pg_zeros", "run_across_a_block"])
def test_multi_block_level1_equals_stdlib(make):
    data = make()
    ours = _cpu(data, 1)
    assert len(rle1_split_blocks(np.frombuffer(data, np.uint8), 1)) == 3
    assert ours == bz2.compress(data, 1)
    assert bz2.decompress(ours) == data


def test_random_data_equals_stdlib():
    data = np.random.default_rng(1).integers(
        0, 256, size=60000).astype(np.uint8).tobytes()
    assert _cpu(data, 9) == bz2.compress(data, 9)


@pytest.mark.parametrize("name", ["periodic", "hello", "runs", "bin"])
def test_equals_tpulc(name):
    """At level 1, where tpulc's sort capacity is 100,096."""
    data = CASES[name]()
    assert _cpu(data, 1) == tpulc_bz2_compress(data, 1)


@pytest.mark.parametrize("name", [*sorted(CASES), "run_across_a_block"])
def test_rle1_split_equals_tpulc(name):
    data = _carry() if name == "run_across_a_block" else CASES[name]()
    arr = np.frombuffer(data, np.uint8)
    level = 1 if name == "run_across_a_block" else 9
    ours, theirs = rle1_split_blocks(arr, level), tpulc_split(arr, level)
    assert len(ours) == len(theirs)
    for (b, u, c), (tb, tu, tc) in zip(ours, theirs):
        assert np.array_equal(b, tb)
        assert np.array_equal(u, tu)
        assert c == tc


def test_rle1_split_of_nothing():
    assert rle1_split_blocks(np.zeros(0, np.uint8), 9) == []


def _masked_cases():
    rng = np.random.default_rng(0)
    return {
        "periodic": np.frombuffer(b"abcab" * 200, np.uint8),
        "constant": np.full(700, 7, np.uint8),
        "random": rng.integers(0, 256, 900).astype(np.uint8),
        "small_alphabet": rng.integers(0, 3, 1000).astype(np.uint8),
        "zero_runs": np.concatenate([np.zeros(5, np.uint8),
                                     np.frombuffer(b"ab" * 100, np.uint8),
                                     np.zeros(7, np.uint8)]),
    }


@pytest.mark.parametrize("name", sorted(_masked_cases()))
def test_masked_bwt_tie_order_equals_tpulc(name):
    d = _masked_cases()[name]
    n, cap = d.shape[0], 1024
    padded = np.zeros(cap, np.uint8)
    padded[:n] = d
    last, idx0 = tpulc_masked(jnp.asarray(padded), jnp.int32(n),
                              tie_desc=True)
    ours, i0 = bwt_encode_masked(torch.from_numpy(padded), n)
    assert np.array_equal(ours.numpy(), np.asarray(last))
    assert i0 == int(idx0)
    # at the block's own length (what the emitter runs)
    own, j0 = bwt_encode_masked(torch.from_numpy(d.copy()), n)
    assert np.array_equal(own.numpy(), np.asarray(last)[:n]) and j0 == i0


def test_crc_equals_tpulc_and_the_bitwise_crc():
    rng = np.random.default_rng(5)
    for data in (b"", b"a", _pg(3000),
                 rng.integers(0, 256, 777).astype(np.uint8).tobytes()):
        assert crc32_bzip2_np(data) == tpulc_crc(data)
        assert crc32_bzip2_np(data) == crc32_bzip2_slow(data)


def test_decode_ours_stdlib_and_a_long_run():
    data = _pg(60000) + b"\x00" * 3000 + _pg(10000)
    ours = bzip2_codec.compress(data, level=9, device="cpu")
    assert ours == bz2.compress(data, 9)
    assert bzip2_codec.decompress(ours, device="cpu") == data
    assert bzip2_codec.decompress(bz2.compress(data, 1), device="cpu") == data
    # ~49 bytes for 5 MiB: the output size must grow from the header's
    # bound, not from a multiple of the stream's length
    run = b"z" * (5 * 1024 * 1024)
    comp = bz2.compress(run, 9)
    assert len(comp) < 256
    assert bzip2_codec.decompress(comp, device="cpu") == run


def test_level_from_block_size_and_cli_default():
    data = _pg(5000)
    assert bzip2_codec.compress(data, block_size=1 << 20, device="cpu") == \
        bz2.compress(data, 9)
    assert bzip2_codec.compress(data, block_size=300_000, device="cpu") == \
        bz2.compress(data, 3)


def test_corrupt_streams_raise():
    data = _pg(60000)
    blob = bz2.compress(data, 9)
    for pos in (12, len(blob) // 2, len(blob) - 6):
        bad = bytearray(blob)
        bad[pos] ^= 0x08
        with pytest.raises(ValueError):
            bzip2_codec.decompress(bytes(bad), device="cpu")
    for bad in (b"", b"BZ", b"BZh0" + blob[4:], b"TPLC" + blob[4:],
                blob[: len(blob) // 2]):
        with pytest.raises(ValueError):
            bzip2_codec.decompress(bad, device="cpu")
    with pytest.raises(ValueError):
        bz2_compress(data, 10, "cpu")


def test_overlong_zero_run_raises():
    """A block of 70 RUNA digits (a zero run of 2^70 - 1, past any block)
    raises ValueError; tpulc's copy of the decoder shifts `runbit` past
    63 bits there."""
    from tpulc_torch.codecs.bwt.bz2stream import BitWriter, send_mtf_values

    bw = BitWriter()
    for c in b"BZh9":
        bw.w(8, c)
    for v, nbits in ((0x314159, 24), (0x265359, 24), (0, 32), (0, 1),
                     (0, 24), (1 << 15, 16), (1 << 15, 16)):
        bw.w(nbits, v)          # magic, CRC, origPtr, symbol 0 in use
    send_mtf_values(bw, np.array([0] * 70 + [2], np.int64), 3)
    for v, nbits in ((0x177245, 24), (0x385090, 24), (0, 32)):
        bw.w(nbits, v)
    with pytest.raises(ValueError, match="invalid"):
        bzip2_codec.decompress(bw.to_bytes(), device="cpu")

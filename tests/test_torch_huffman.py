"""The huffman codec of tpulc_torch against tpulc's, on the CPU.

Package-merge and canonical codes are integer arithmetic, so every
container must be byte-identical to tpulc's; each package decodes the
other's containers; every decoder choice (`kernel=` and the
TPULC_HUFF_KERNEL override) gives the same bytes; and the port's
payload parser refuses what tpulc would silently misdecode (ROADMAP F2).
"""

import contextlib
import struct
import tracemalloc

import numpy as np
import pytest
import torch

from tpulc.codecs.huffman import driver as jdrv
from tpulc_torch.codecs.huffman import driver
from tpulc_torch.pipeline.container import Container
from tpulc_torch.pipeline.registry import get_codec
from tpulc_torch.primitives.checksum import adler32_np
from tpulc_torch.utils import timing

torch.set_num_threads(1)

KERNELS = ["ranks", "v1", "buffered", "flat"]


def _pg(n):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read(n)


def _case(name):
    """-> (data, compress keyword arguments)."""
    bs = {"block_size": 1 << 16}
    if name == "pg_v2":        # chunk 128, u16 deltas; partial tail block
        return _pg(150000), bs
    if name == "pg_v1":        # chunk 256, u32 absolute offsets
        return _pg(150000), {**bs, "chunk_syms": 256}
    if name == "pg_selfsync":  # no chunk table: the self-sync decoder
        return _pg(150000), {**bs, "aligned": False}
    if name == "random":
        rng = np.random.default_rng(5)
        return rng.integers(0, 256, 70000).astype(np.uint8).tobytes(), bs
    if name == "single_symbol":
        return b"q" * 3000, bs
    if name == "one_byte":
        return b"x", bs
    if name == "empty":        # one block with n = 0
        return b"", bs
    raise KeyError(name)


CASES = ["pg_v2", "pg_v1", "pg_selfsync", "random", "single_symbol",
         "one_byte", "empty"]


@pytest.fixture(scope="module")
def containers():
    """name -> (data, kwargs, tpulc container, port container)."""
    out = {}
    for name in CASES:
        data, kw = _case(name)
        out[name] = (data, kw, jdrv.compress(data, **kw),
                     driver.compress(data, device="cpu", **kw))
    return out


@pytest.mark.parametrize("name", CASES)
def test_container_is_tpulcs(containers, name):
    data, _, theirs, ours = containers[name]
    assert ours == theirs
    c = Container.from_bytes(ours)
    assert len(c.payloads) == max(1, -(-len(data) // (1 << 16)))


@pytest.mark.parametrize("name", CASES)
def test_cross_decode(containers, name):
    data, _, theirs, ours = containers[name]
    assert driver.decompress(theirs, device="cpu") == data
    assert jdrv.decompress(ours) == data


@pytest.mark.parametrize("kernel", KERNELS)
def test_every_decoder_gives_the_same_bytes(containers, kernel):
    for name in CASES:
        data, _, _, ours = containers[name]
        assert driver.decompress(ours, device="cpu", kernel=kernel) == data, name


def test_env_override_and_bad_choice(containers, monkeypatch):
    data, _, _, ours = containers["pg_v2"]
    monkeypatch.setenv("TPULC_HUFF_KERNEL", "flat")
    assert driver.decompress(ours, device="cpu") == data
    monkeypatch.setenv("TPULC_HUFF_KERNEL", "pallas")
    with pytest.raises(ValueError, match="ranks|v1|buffered|flat"):
        driver.decompress(ours, device="cpu")
    with pytest.raises(ValueError):
        driver.decompress(ours, device="cpu", kernel="mxu")


def _container(payloads: list[bytes], data: bytes, bs: int) -> bytes:
    return Container(codec_id=1, flags=driver.FLAG_ALIGNED,
                     orig_len=len(data), block_size=bs,
                     comp_sizes=[len(p) for p in payloads], payloads=payloads,
                     data_adler=adler32_np(data)).to_bytes()


def _mixed(data: bytes, bs: int, v1_blocks) -> bytes:
    """`data`'s container with the blocks `v1_blocks` in v1 chunking and
    the rest in v2, so that a group holding both falls back."""
    a = Container.from_bytes(driver.compress(data, block_size=bs,
                                             device="cpu"))
    b = Container.from_bytes(driver.compress(data, block_size=bs,
                                             chunk_syms=256, device="cpu"))
    payloads = [(b if j in v1_blocks else a).payloads[j]
                for j in range(len(a.payloads))]
    return _container(payloads, data, bs)


def test_mixed_chunking_falls_back_per_block():
    """A group whose blocks use v1 and v2 chunking decodes block by block
    (tpulc `driver.py:269-272`), first group or after an aligned one."""
    data = _pg(100000)
    bs = 1 << 15
    mixed = _mixed(data, bs, {1, 3})
    assert driver._parse_aligned_group(Container.from_bytes(mixed).payloads,
                                       bs) is None
    for kernel in KERNELS:
        assert driver.decompress(mixed, device="cpu", kernel=kernel) == data
    assert jdrv.decompress(mixed) == data
    groups = Container.from_bytes(_one_buffer_case("mixed_chunking")[1]
                                  ).payloads
    assert driver._parse_aligned_group(groups[:128], 512) is not None
    assert driver._parse_aligned_group(groups[128:], 512) is None


def _short_middle_block() -> tuple[bytes, bytes]:
    """Three blocks of 1,024, 500 and 1,024 symbols under block_size
    1,024: a group whose blocks are not a prefix of its rows."""
    pg = _pg(2548)
    blocks = [pg[:1024], pg[1024:1524], pg[1524:]]
    payloads = [driver.compress_block(np.frombuffer(b, np.uint8),
                                      block_cap=1024, device="cpu")
                for b in blocks]
    return pg, _container(payloads, pg, 1024)


def _one_buffer_case(name):
    """-> (data, container) for `test_decompress_fills_one_buffer`."""
    if name == "short_middle_block":
        return _short_middle_block()
    if name == "mixed_chunking":      # 132 blocks: group 2 falls back
        data = _pg(512 * 131 + 100)
        return data, _mixed(data, 512, {129})
    data, bs = {
        "empty": (b"", 1 << 16),
        "partial_block": (_pg(40000), 1 << 16),
        "full_block": (_pg(1 << 16), 1 << 16),
        "two_groups": (_pg(512 * 131 + 100), 512),       # 132 blocks
        "ragged_tail": (_pg(150000), 1 << 16),           # 65,536 x 2 + 18,928
        "block_not_chunked": (_pg(3500), 1000),          # rows of 1,024
    }[name]
    return data, driver.compress(data, block_size=bs, device="cpu")


@pytest.mark.parametrize("name", [
    "empty", "partial_block", "full_block", "two_groups", "ragged_tail",
    "block_not_chunked", "short_middle_block", "mixed_chunking"])
def test_decompress_fills_one_buffer(name):
    """Every way the groups' symbols land in the one output array: a
    prefix of the rows, rows narrowed on the device, rows gathered one
    by one, blocks decoded one at a time, two groups in one array."""
    data, blob = _one_buffer_case(name)
    out = driver.decompress(blob, device="cpu")
    assert type(out) is bytes
    assert out == data
    assert jdrv.decompress(blob) == data


def test_decompress_copies_the_output_once(monkeypatch):
    """The decoded bytes are copied into `bytes` once (`huffman.join`)
    and checksummed in place (`huffman.adler32`): per-block copies and
    a join, or a copy for the checksum, would grow the traced heap by a
    second or a first copy of the output."""
    pg = _pg(-1)
    data = (pg * (-(-(4 << 20) // len(pg))))[: 4 << 20]
    blob = driver.compress(data, block_size=1 << 20, device="cpu")
    grown, peaks = {}, []
    real = timing.stage

    @contextlib.contextmanager
    def stage(name):
        if name not in ("huffman.join", "huffman.adler32"):
            with real(name):
                yield
            return
        start, peak = tracemalloc.get_traced_memory()
        peaks.append(peak)
        tracemalloc.reset_peak()
        with real(name):
            yield
        grown[name] = tracemalloc.get_traced_memory()[1] - start

    monkeypatch.setattr(timing, "stage", stage)
    tracemalloc.start()
    try:
        out = driver.decompress(blob, device="cpu")
        peaks.append(tracemalloc.get_traced_memory()[1])
    finally:
        tracemalloc.stop()
    n = len(data)
    assert out == data
    assert grown["huffman.join"] < 1.25 * n
    assert grown["huffman.adler32"] < 0.05 * n
    assert max(peaks) < 2.25 * n + len(blob)


def test_compress_and_decompress_block_match_the_batch():
    data = np.frombuffer(_pg(40000), np.uint8)
    for kw in ({}, {"chunk_syms": 256}, {"aligned": False}):
        payload = driver.compress_block(data, block_cap=1 << 16,
                                        device="cpu", **kw)
        assert payload == jdrv.compress_block(data, block_cap=1 << 16, **kw)
        got = driver.decompress_block(payload, block_cap=1 << 16,
                                      device="cpu")
        np.testing.assert_array_equal(got, data)


def test_registry_and_defaults():
    assert get_codec("huffman") is driver
    assert get_codec(1) is driver
    with pytest.raises(ValueError, match="multiple of 8"):
        driver.compress(b"abc", chunk_syms=4, device="cpu")


def _payload_v2(chunk_log: int, nchunks: int, n: int = 64) -> bytes:
    """A FLAG_ALIGNED2 payload with the given chunk fields and an
    all-zero 1-bit code (symbol 0, length 1)."""
    lengths = np.zeros(128, np.uint8)
    lengths[0] = 1                       # symbol 0: length 1, code 0
    head = struct.pack("<IIB", n, n, driver.FLAG_ALIGNED2) + lengths.tobytes()
    deltas = np.zeros(nchunks, "<u2")
    deltas[0] = n
    words = np.zeros(-(-n // 32), "<u4")
    return (head + struct.pack("<BI", chunk_log, nchunks) + deltas.tobytes()
            + words.tobytes())


def test_f2_parser_refuses_bad_chunk_fields():
    ok = _payload_v2(chunk_log=6, nchunks=1)           # 64 symbols, 1 chunk
    np.testing.assert_array_equal(
        driver.decompress_block(ok, block_cap=64, device="cpu"),
        np.zeros(64, np.uint8))
    with pytest.raises(ValueError, match="multiple of 8"):
        driver.decompress_block(_payload_v2(chunk_log=2, nchunks=16),
                                block_cap=64, device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        driver.decompress_block(_payload_v2(chunk_log=3, nchunks=3),
                                block_cap=64, device="cpu")
    with pytest.raises(ValueError, match="truncated"):
        driver.decompress_block(ok[:-4], block_cap=64, device="cpu")


def test_f2_refused_through_the_container():
    """The same checks hold when the bad payload sits in a container
    whose checksums are valid."""
    bad = _payload_v2(chunk_log=2, nchunks=16)
    c = Container(codec_id=1, flags=1, orig_len=64, block_size=64,
                  comp_sizes=[len(bad)], payloads=[bad],
                  data_adler=Container.from_bytes(driver.compress(
                      bytes(64), block_size=64, device="cpu")).data_adler)
    with pytest.raises(ValueError, match="multiple of 8"):
        driver.decompress(c.to_bytes(), device="cpu")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.compress(b"abc")
    blob = driver.compress(b"abc", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.decompress(blob)

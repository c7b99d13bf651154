"""The port's Dipperstein lzss codec (`codecs/lzss/*`,
`primitives/parallel.orbit_flags`) against tpulc's (through JAX on the
CPU) and the lzss-0.6.2 C gold (`tpulc/gold/lzss_gold`): tpulc's
interop matrix on its five 10,240-byte cases, the same raw streams and
containers, cross-decoding both ways, and the port's ValueErrors where
tpulc asserts."""

import numpy as np
import pytest
import torch

from tpulc.codecs.lzss import driver as tpulc_lzss
from tpulc.gold.lzss_gold import lzss_decode as gold_decode
from tpulc.gold.lzss_gold import lzss_encode as gold_encode
from tpulc.primitives.parallel import orbit_flags as tpulc_orbit_flags
from tpulc_torch.codecs.lzss import driver
from tpulc_torch.pipeline.container import Container
from tpulc_torch.pipeline.registry import CODEC_BZ
from tpulc_torch.primitives.parallel import orbit_flags

torch.set_num_threads(1)

CASE_LEN = 10240


def _pg(n, start=0):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read()[start: start + n]


def _fit(b: bytes) -> bytes:
    return (b * (CASE_LEN // len(b) + 1))[:CASE_LEN]


CASES = {
    "text": lambda: _pg(CASE_LEN),
    "runs": lambda: _fit(b"abcabcabc"),
    "random": lambda: np.random.default_rng(3).integers(
        0, 256, size=CASE_LEN).astype(np.uint8).tobytes(),
    "spaces": lambda: _fit(b"   leading spaces match the virtual window   "),
    "binary": lambda: _fit(bytes(range(256))),
}


def _raw(data, exact=False):
    return driver.compress_raw(data, exact=exact, device="cpu")


@pytest.mark.parametrize("exact", [False, True], ids=["chains", "exact"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_raw_stream_equals_tpulc(name, exact):
    data = CASES[name]()
    ours = _raw(data, exact)
    assert ours == tpulc_lzss.compress_raw(data, exact=exact)
    assert driver.decompress_raw(ours, CASE_LEN + 64, device="cpu") == data


@pytest.mark.parametrize("name", sorted(CASES))
def test_gold_interop_and_exact_size(name):
    data = CASES[name]()
    gold = gold_encode(data)
    assert driver.decompress_raw(gold, CASE_LEN + 64, device="cpu") == data
    assert gold_decode(_raw(data), CASE_LEN + 64) == data
    exact = _raw(data, exact=True)
    assert len(exact) == len(gold)
    assert gold_decode(exact, CASE_LEN + 64) == data


@pytest.mark.parametrize("exact", [False, True], ids=["chains", "exact"])
@pytest.mark.parametrize("tail", [
    _pg(3000, 9000),
    # the tail block's last bytes came before zeros earlier in it: the
    # last match runs into tpulc's bucket padding
    b"xyz" + bytes(6) + _pg(500) + b"xyz"],
    ids=["text", "match_into_the_bucket"])
def test_containers_equal_tpulc_and_cross_decode(tail, exact):
    data = _pg(8192) + tail
    ours = driver.compress(data, block_size=8192, exact=exact, device="cpu")
    theirs = tpulc_lzss.compress(data, block_size=8192, exact=exact)
    assert ours == theirs
    assert len(Container.from_bytes(ours).payloads) == 2
    assert driver.decompress(theirs, device="cpu") == data
    assert tpulc_lzss.decompress(ours) == data


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_orbit_flags_equals_tpulc(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    jump = np.minimum(np.arange(n) + rng.integers(1, 19, size=n), n)
    jump_e = np.append(jump, n).astype(np.int32)
    want = np.asarray(tpulc_orbit_flags(jump_e, n, n))
    got = orbit_flags(torch.from_numpy(jump_e), n, n).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("data", [b"", b"a", b"abc"], ids=["0", "1", "3"])
def test_tiny_inputs(data):
    if data:
        raw = _raw(data)
        assert raw == tpulc_lzss.compress_raw(data)
        assert driver.decompress_raw(raw, len(data) + 64, device="cpu") == data
    comp = driver.compress(data, block_size=4096, device="cpu")
    assert comp == tpulc_lzss.compress(data, block_size=4096)
    assert driver.decompress(comp, device="cpu") == data


def test_truncated_payload_and_wrong_codec_raise():
    """tpulc asserts on both (`driver.py:68,139`), which `python -O`
    drops; the port raises ValueError."""
    data = _pg(20000)
    c = Container.from_bytes(driver.compress(data, block_size=8192,
                                             device="cpu"))
    short = c.payloads[1][: len(c.payloads[1]) // 2]
    cut = Container(codec_id=c.codec_id, flags=0, orig_len=c.orig_len,
                    block_size=c.block_size,
                    comp_sizes=[len(c.payloads[0]), len(short),
                                len(c.payloads[2])],
                    payloads=[c.payloads[0], short, c.payloads[2]],
                    data_adler=c.data_adler)
    with pytest.raises(ValueError, match="corrupt lzss block"):
        driver.decompress(cut.to_bytes(), device="cpu")
    other = Container(codec_id=CODEC_BZ, flags=0, orig_len=c.orig_len,
                      block_size=c.block_size, comp_sizes=c.comp_sizes,
                      payloads=c.payloads, data_adler=c.data_adler)
    with pytest.raises(ValueError, match="not an lzss container"):
        driver.decompress(other.to_bytes(), device="cpu")

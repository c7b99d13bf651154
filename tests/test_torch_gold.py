"""The port's golds (`gold/lzss_gold.py` over `gold/lzss_gold.c`, and
`gold/culzss_gold.py`) against tpulc's: the same lzss streams and the
same CULZSS packets, each package's gold decoding the other's streams,
and the lzss gold reading and writing the port's device codec's bare
streams."""

import numpy as np
import pytest
import torch

from tpulc.gold import culzss_gold as tpulc_culzss_gold
from tpulc.gold import lzss_gold as tpulc_lzss_gold
from tpulc_torch.codecs.lzss import driver as lzss
from tpulc_torch.gold import culzss_gold, lzss_gold

torch.set_num_threads(1)


def _pg(start, n):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read()[start: start + n]


LZSS_CASES = {
    "pg_head": lambda: _pg(0, 20_000),
    "pg_middle": lambda: _pg(250_000, 12_345),
    "random": lambda: np.random.default_rng(1).integers(
        0, 256, 5000).astype(np.uint8).tobytes(),
    "runs": lambda: b"\x00" * 3000 + b"ab" * 1500 + b" " * 4500 + b"z" * 17,
    "short": lambda: b"abcab",  # under the 18-byte lookahead
    "empty": lambda: b"",
}


@pytest.mark.parametrize("name", LZSS_CASES)
def test_lzss_gold_equals_tpulc(name):
    data = LZSS_CASES[name]()
    enc = lzss_gold.lzss_encode(data)
    assert enc == tpulc_lzss_gold.lzss_encode(data)
    cap = len(data) + 64
    assert lzss_gold.lzss_decode(enc, cap) == data
    assert tpulc_lzss_gold.lzss_decode(enc, cap) == data
    if not data:
        return
    # the device codec's bare stream, both ways
    raw = lzss.compress_raw(data, device="cpu")
    assert lzss_gold.lzss_decode(raw, cap) == data
    assert lzss.decompress_raw(enc, cap, device="cpu") == data


def test_lzss_gold_decode_overflow_raises():
    enc = lzss_gold.lzss_encode(b"a" * 100)
    with pytest.raises(RuntimeError):
        lzss_gold.lzss_decode(enc, 50)


CULZSS_CASES = {
    "full_packet": lambda: _pg(4096 * 5, 4096),
    "short_tail": lambda: _pg(100_000, 1000),
    "raw": lambda: np.random.default_rng(2).integers(
        0, 256, 4096).astype(np.uint8).tobytes(),
    "z_run": lambda: b"z" * 4096,
}


@pytest.mark.parametrize("name", CULZSS_CASES)
def test_culzss_gold_equals_tpulc(name):
    data = CULZSS_CASES[name]()
    enc = culzss_gold.encode_packet(data)
    assert enc == tpulc_culzss_gold.encode_packet(data)
    assert culzss_gold.decode_packet(enc) == data
    assert tpulc_culzss_gold.decode_packet(enc) == data

"""The port's LZP library (its own build of `tpulc_torch/gold/lzp.c`)
against tpulc's `gold.lzp` on the same bytes: equal streams, equal
`None` answers, and a round trip through the port's decoder."""

import numpy as np
import pytest
import torch

from tpulc.gold import lzp as tlzp
from tpulc_torch.gold import build
from tpulc_torch.gold import lzp as plzp

torch.set_num_threads(1)


def _pg(n=None):
    with open("tests/data/pg1661.txt", "rb") as f:
        raw = f.read()
    return raw * 2 if n is None else raw[:n]


def _inputs():
    rng = np.random.default_rng(7)
    return {
        "pg1661x2": _pg(),
        "random": rng.integers(0, 256, 50000).astype(np.uint8).tobytes(),
        "escapes": (b"\xf2" * 300 + _pg(20000)) * 2,
        "tiny": _pg(63),
        "ctx": _pg(64),
    }


@pytest.mark.parametrize("name", list(_inputs()))
def test_lzp_equals_tpulc_and_round_trips(name):
    data = _inputs()[name]
    ours, theirs = plzp.lzp_encode(data), tlzp.lzp_encode(data)
    assert ours == theirs
    if len(data) < 64:
        assert ours is None
    if ours is not None:
        assert len(ours) < len(data)
        assert plzp.lzp_decode(ours, len(data)) == data
        assert plzp.lzp_decode(np.frombuffer(ours, np.uint8),
                               len(data)) == data


def test_lzp_decode_rejects_a_short_stream():
    with pytest.raises(ValueError):
        plzp.lzp_decode(b"abc", 100)


def test_lzp_library_is_built_from_the_port_sources():
    plzp._load()
    assert build.so_path(plzp._SRC).startswith(build._BUILD)
    assert "tpulc_torch" in plzp._SRC and "libtpulc_gold" not in plzp._SRC

"""The port's bsc `-e2` codec on the edges, against tpulc: random bytes
(stored), one byte and empty give tpulc's containers and cross-decode;
a flipped byte raises; the ST sorters, once refused, now compress and
decode tpulc's ST containers, and a coder compress does not take raises
ValueError.  Coder 1's edges are in `test_torch_bsc_e1.py`, the ST
sorters' in `test_torch_bsc_st.py`."""

import numpy as np
import pytest
import torch

from tpulc.codecs.bsclike import driver as td
from tpulc_torch.codecs.bsclike import driver as pd
from tpulc_torch.pipeline.container import Container
from tpulc_torch.pipeline.registry import get_codec

torch.set_num_threads(1)


def _pg(n):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read()[:n]


@pytest.mark.parametrize("name", ["random", "one_byte", "empty"])
def test_stored_and_tiny_equal_tpulc(name):
    data = {"random": np.random.default_rng(5).integers(
        0, 256, 20000).astype(np.uint8).tobytes(),
        "one_byte": b"x", "empty": b""}[name]
    ours = pd.compress(data, block_size=65536, coder=2, device="cpu")
    theirs = td.compress(data, block_size=65536, coder=2)
    assert ours == theirs
    payload = Container.from_bytes(ours).payloads[0]
    assert payload[pd._HEAD.size - 2] & pd.FLAG_STORED
    assert pd.decompress(theirs, device="cpu") == data
    assert td.decompress(ours) == data


def test_options_equal_tpulc():
    """--no-lzp, an explicit filter and the registry entry point."""
    data = _pg(6000)
    for kw in ({"use_lzp": False}, {"filter_mode": "reverse"},
               {"filter_mode": "reorder:3"}):
        ours = get_codec("bsc").compress(data, block_size=8192, coder=2,
                                         device="cpu", **kw)
        assert ours == td.compress(data, block_size=8192, coder=2, **kw)
        assert pd.decompress(ours, device="cpu") == data


def test_flipped_byte_raises():
    data = _pg(20000)
    c = bytearray(pd.compress(data, block_size=32768, coder=2, device="cpu"))
    c[len(c) // 2] ^= 0x20
    with pytest.raises(Exception):
        pd.decompress(bytes(c), device="cpu")


def test_hostile_lane_count_raises():
    data = _pg(20000)
    c = Container.from_bytes(pd.compress(data, block_size=32768, coder=2,
                                         device="cpu"))
    p = bytearray(c.payloads[0])
    assert p[pd._HEAD.size - 2] == pd.FLAG_ANCHORS
    # header, anchors (15 bits each at cap 32768), inits, cinits, then
    # maxbits and nlanes
    m_lzp = int.from_bytes(p[4:8], "little")
    anchors = -(-m_lzp // pd.ANCHOR_STRIDE)
    _, off = pd.G.unpack_inits(bytes(p), pd._HEAD.size + -(-anchors * 15 // 8))
    off += 2 * pd.G.NFAM + 4
    p[off: off + 4] = (10 ** 6).to_bytes(4, "little")
    with pytest.raises(ValueError, match="grc payload geometry"):
        pd.decompress_block(bytes(p), 32768, device="cpu")


def test_not_ported_yet_raises():
    """What this test once refused (the ST sorters, both coders, and
    tpulc's ST containers) now works; coder 4 still raises."""
    data = _pg(5000)
    st8_e2 = pd.compress(data, block_size=65536, coder=2, sorter="st8",
                         device="cpu")
    assert st8_e2 == td.compress(data, block_size=65536, coder=2,
                                 sorter="st8")
    assert pd.decompress(st8_e2, device="cpu") == data
    st4 = pd.compress(data, block_size=65536, sorter="st4", device="cpu")
    assert pd.decompress(st4, device="cpu") == data
    theirs = td.compress(data, block_size=65536, sorter="st4")  # coder 1
    assert st4 == theirs
    assert pd.decompress(theirs, device="cpu") == data
    # tpulc writes a coder-1 container here; the port refuses the value
    with pytest.raises(ValueError, match="coder 1 or 2"):
        pd.compress(data, block_size=65536, coder=4, device="cpu")

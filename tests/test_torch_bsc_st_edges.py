"""The port's bsc codec on the ST sorters at the edges, against tpulc
on the same inputs: a block the segmentation detector splits, `--no-lzp`,
random bytes (the stored fallback), one byte and empty give tpulc's
containers, and each package decodes the other's.  Hostile ST and
adaptive-coder payloads raise ValueError where tpulc reads out of
bounds or decodes through clamped gathers: an idx0 that is no row of
the stage (tpulc's C walk would read L[idx0] first), more lanes than
the transform holds, nwords other than the counts' sum or past the
payload, maxbits over 16 bits a symbol, m or m_lzp over the capacity,
truncated inits or lane fields.  (The walk's own failure, -1, is
checked in `test_torch_stk.py`.)"""

import struct

import numpy as np
import pytest
import torch

from tpulc.codecs.bsclike import driver as td
from tpulc_torch.codecs.bsclike import driver as pd
from tpulc_torch.pipeline.container import Container

torch.set_num_threads(1)


def _pg(n):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read()[:n]


def _input(name):
    rng = np.random.default_rng(3)
    return {"segmented": _pg(30000) + rng.integers(0, 256, 8000).astype(
                np.uint8).tobytes(),
            "no_lzp": _pg(20000),
            "random": rng.integers(0, 256, 20000).astype(np.uint8).tobytes(),
            "one_byte": b"x", "empty": b""}[name]


@pytest.mark.parametrize("name,sorter,coder", [
    (name, "st8", 2) for name in ("segmented", "no_lzp", "random",
                                  "one_byte", "empty")]
    + [(name, "st4", 1) for name in ("segmented", "random", "one_byte",
                                     "empty")]
    + [("no_lzp", "st8w", 2)])
def test_st_edges_equal_tpulc(name, sorter, coder):
    data = _input(name)
    kw = dict(block_size=65536, sorter=sorter, coder=coder,
              use_lzp=name != "no_lzp")
    ours = pd.compress(data, device="cpu", **kw)
    theirs = td.compress(data, **kw)
    assert ours == theirs
    (payload,) = Container.from_bytes(ours).payloads
    flags, byte = payload[pd._HEAD.size - 2], payload[pd._HEAD.size - 1]
    if name == "segmented":
        assert byte == pd.CODER_SEGMENTED
    elif name in ("random", "one_byte", "empty"):
        assert flags == pd.FLAG_STORED
    else:
        assert not flags & pd.FLAG_LZP
    assert pd.decompress(theirs, device="cpu") == data
    assert td.decompress(ours) == data


@pytest.fixture(scope="module")
def payloads():
    """One adaptive-coder and one coder-1 payload on ST-8 (pg1661[:20000]
    at 32 KiB), and the adaptive one's field offsets."""
    data = _pg(20000)
    out = {}
    for coder in (1, 2):
        (p,) = Container.from_bytes(pd.compress(
            data, block_size=32768, sorter="st8", coder=coder,
            device="cpu")).payloads
        assert not p[pd._HEAD.size - 2] & (pd.FLAG_STORED | pd.FLAG_FILTER
                                           | pd.FLAG_ANCHORS)
        assert pd.decompress_block(p, 32768, device="cpu").tobytes() == data
        out[coder] = p
    return out


def _field(p, off, fmt, value):
    p = bytearray(p)
    struct.pack_into(fmt, p, off, value)
    return bytes(p)


# the adaptive payload: header, inits (NMODELS u16), maxbits, nlanes,
# lane classes, counts, states, words
_INITS = pd._HEAD.size
_MAXBITS = _INITS + 2 * pd.NMODELS
_NLANES = _MAXBITS + 4


def _hostile(p, fault):
    m_lzp = struct.unpack_from("<I", p, 4)[0]
    if fault == "idx0":
        return _field(p, 12, "<I", m_lzp), "geometry"
    if fault == "m":
        return _field(p, 8, "<I", 10 ** 6), "geometry"
    if fault == "m_lzp":
        return _field(p, 4, "<I", 40000), "geometry"
    if fault == "nlanes":
        return _field(p, _NLANES, "<I", 33), "geometry"
    if fault == "maxbits":
        return _field(p, _MAXBITS, "<I", 16 * 1024 + 1), "geometry"
    if fault == "nwords":
        nw = struct.unpack_from("<I", p, 16)[0]
        return _field(p, 16, "<I", nw - 1), "lanes"
    if fault == "past_payload":
        return p[:-2], "lanes"
    if fault == "inits":
        return p[: _INITS + 100], "truncated inits"
    nl = struct.unpack_from("<I", p, _NLANES)[0]
    return p[: _NLANES + 4 + 3 * nl], "truncated lanes"


@pytest.mark.parametrize("fault", ["idx0", "m", "m_lzp", "nlanes", "maxbits",
                                   "nwords", "past_payload", "inits",
                                   "lane_cls"])
def test_hostile_abc_payload_raises(payloads, fault):
    p, match = _hostile(payloads[2], fault)
    with pytest.raises(ValueError, match=match):
        pd.decompress_block(p, 32768, device="cpu")


@pytest.mark.parametrize("fault", ["idx0", "m_lzp"])
def test_hostile_st_coder1_payload_raises(payloads, fault):
    """tpulc would hand this idx0 to its C walk unchecked."""
    p, _ = _hostile(payloads[1], fault)
    with pytest.raises(ValueError, match="geometry"):
        pd.decompress_block(p, 32768, device="cpu")

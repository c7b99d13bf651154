"""The port's bsc `-e1` codec (coder 1, tpulc's default) against
tpulc's on the same inputs: the containers are byte-identical, and each
package decodes the other's.

Inputs: `test_torch_bsc.py`'s three (pg1661[:50000] at 64 KiB, a
text|random-bytes block that the segmentation detector splits, a
fixed-record block for which `--filter auto` picks a reorder filter),
three blocks of pg1661 (the batched coder and its common transform
capacity), `--no-lzp`, `reverse`, `reorder:3`, random bytes (stored),
one byte and empty; and hostile coder-1 payloads, which raise
ValueError where tpulc asserts or decodes through clamped gathers."""

import numpy as np
import pytest
import torch

from tpulc.codecs.bsclike import driver as td
from tpulc_torch.codecs.bsclike import driver as pd
from tpulc_torch.codecs.bsclike import filters as pf
from tpulc_torch.pipeline.container import Container
from tpulc_torch.pipeline.registry import get_codec

torch.set_num_threads(1)


def _pg(n):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read()[:n]


def _input(name):
    rng = np.random.default_rng(3)
    if name == "pg1661_50k":
        return _pg(50000), 65536
    if name == "text_random":
        return _pg(30000) + rng.integers(0, 256, 8000).astype(
            np.uint8).tobytes(), 65536
    if name == "three_blocks":
        return _pg(150000), 65536
    rec = np.tile(np.arange(12, dtype=np.uint8), 3000) \
        + rng.integers(0, 3, 36000).astype(np.uint8)
    return rec.tobytes(), 65536


@pytest.fixture(scope="module", params=["pg1661_50k", "text_random",
                                        "records", "three_blocks"])
def case(request):
    data, bs = _input(request.param)
    ours = pd.compress(data, block_size=bs, device="cpu")
    theirs = td.compress(data, block_size=bs)
    return request.param, data, bs, ours, theirs


def _coders(container):
    """(coder byte, flags) of each block payload."""
    h = pd._HEAD.size
    return [(p[h - 1], p[h - 2]) for p in Container.from_bytes(container)
            .payloads]


def test_container_equals_tpulc(case):
    name, data, bs, ours, theirs = case
    assert ours == theirs
    coders = _coders(ours)
    ctx = pd.FLAG_CTX | pd.FLAG_ANCHORS
    if name == "text_random":
        segs = pf.detect_segments_gated(np.frombuffer(data, np.uint8))
        assert len(segs) == 2
        assert coders[0][0] == pd.CODER_SEGMENTED
    elif name == "records":
        assert pf.detect_record_size(np.frombuffer(data, np.uint8)) == 12
        assert len(coders) == 1 and coders[0][0] == pd.CODER_RANS
        assert coders[0][1] & pd.FLAG_FILTER
    else:
        assert len(coders) == (3 if name == "three_blocks" else 1)
        assert all(c == pd.CODER_RANS and f & ctx == ctx for c, f in coders)


def test_port_decodes_tpulc_container(case):
    _, data, _, _, theirs = case
    assert pd.decompress(theirs, device="cpu") == data


def test_tpulc_decodes_port_container(case):
    _, data, _, ours, _ = case
    assert td.decompress(ours) == data


@pytest.mark.parametrize("kw", [{"use_lzp": False},
                                {"filter_mode": "reverse"},
                                {"filter_mode": "reorder:3"}],
                         ids=["no_lzp", "reverse", "reorder3"])
def test_options_equal_tpulc(kw):
    """--no-lzp and explicit filters through the registry entry point."""
    data = _pg(6000)
    ours = get_codec("bsc").compress(data, block_size=8192, device="cpu",
                                     **kw)
    assert ours == td.compress(data, block_size=8192, **kw)
    assert pd.decompress(ours, device="cpu") == data
    assert td.decompress(ours) == data


@pytest.mark.parametrize("name", ["random", "one_byte", "empty"])
def test_stored_and_tiny_equal_tpulc(name):
    data = {"random": np.random.default_rng(5).integers(
        0, 256, 20000).astype(np.uint8).tobytes(),
        "one_byte": b"x", "empty": b""}[name]
    ours = pd.compress(data, block_size=65536, device="cpu")
    theirs = td.compress(data, block_size=65536)
    assert ours == theirs
    payload = Container.from_bytes(ours).payloads[0]
    assert payload[pd._HEAD.size - 2] & pd.FLAG_STORED
    assert payload[pd._HEAD.size - 1] == pd.CODER_RANS
    assert pd.decompress(theirs, device="cpu") == data
    assert td.decompress(ours) == data


@pytest.fixture(scope="module")
def payload():
    """One coder-1 payload (pg1661[:20000] at 32 KiB) and the offset of
    its nlanes field."""
    p = Container.from_bytes(pd.compress(_pg(20000), block_size=32768,
                                         device="cpu")).payloads[0]
    assert p[pd._HEAD.size - 2] & ~pd.FLAG_LZP == pd.FLAG_CTX | pd.FLAG_ANCHORS
    m_lzp = int.from_bytes(p[4:8], "little")
    off = pd._HEAD.size + -(-(-(-m_lzp // pd.ANCHOR_STRIDE)) * 15 // 8)
    _, off = pd._unpack_freq_tables(p, off)
    return p, off


def _nlanes(p, off):
    return int.from_bytes(p[off: off + 4], "little")


@pytest.mark.parametrize("fault", ["no_ctx_flag", "nlanes", "count",
                                   "nwords"])
def test_hostile_payload_raises(payload, fault):
    p, off = payload
    assert pd.decompress_block(bytes(p), 32768, device="cpu").shape[0] \
        == 20000
    p = bytearray(p)
    if fault == "no_ctx_flag":
        p[pd._HEAD.size - 2] &= ~pd.FLAG_CTX
        match = "FLAG_CTX"
    elif fault == "nlanes":
        p[off: off + 4] = (10 ** 6).to_bytes(4, "little")
        match = "geometry"
    elif fault == "count":
        nl = _nlanes(p, off)
        c0 = off + 4 + -(-nl * pd.FCTX_BITS // 8)
        p[c0: c0 + 2] = (pd.CHUNK + 3).to_bytes(2, "little")
        match = "lanes"
    else:
        p[16:20] = (int.from_bytes(p[16:20], "little") + 1).to_bytes(
            4, "little")
        match = "lanes"
    with pytest.raises(ValueError, match=match):
        pd.decompress_block(bytes(p), 32768, device="cpu")

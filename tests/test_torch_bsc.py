"""The port's bsc `-e2` codec against tpulc's on the same inputs: the
containers are byte-identical, and each package decodes the other's.

Inputs: pg1661[:50000] at 64 KiB blocks (the bench text), a
text|random-bytes block that the segmentation detector splits, a
fixed-record block for which `--filter auto` picks a reorder filter.
The stored, tiny, corrupt and not-yet-ported cases are in
`test_torch_bsc_edges.py`."""

import numpy as np
import pytest
import torch

from tpulc.codecs.bsclike import driver as td
from tpulc_torch.codecs.bsclike import driver as pd
from tpulc_torch.codecs.bsclike import filters as pf
from tpulc_torch.pipeline.container import Container

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
    rec = np.tile(np.arange(12, dtype=np.uint8), 3000) \
        + rng.integers(0, 3, 36000).astype(np.uint8)
    return rec.tobytes(), 65536


@pytest.fixture(scope="module", params=["pg1661_50k", "text_random",
                                        "records"])
def case(request):
    data, bs = _input(request.param)
    ours = pd.compress(data, block_size=bs, coder=2, device="cpu")
    theirs = td.compress(data, block_size=bs, coder=2)
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
    if name == "text_random":
        segs = pf.detect_segments_gated(np.frombuffer(data, np.uint8))
        assert len(segs) == 2
        assert coders[0][0] == pd.CODER_SEGMENTED
    elif name == "records":
        assert pf.detect_record_size(np.frombuffer(data, np.uint8)) == 12
        assert len(coders) == 1 and coders[0][0] == pd.CODER_GRC
        assert coders[0][1] & pd.FLAG_FILTER
    else:
        assert coders[0] == (pd.CODER_GRC, pd.FLAG_ANCHORS)


def test_port_decodes_tpulc_container(case):
    _, data, _, _, theirs = case
    assert pd.decompress(theirs, device="cpu") == data


def test_tpulc_decodes_port_container(case):
    _, data, _, ours, _ = case
    assert td.decompress(ours) == data

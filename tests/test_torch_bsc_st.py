"""The port's bsc codec on the ST sorters (`-m st3..st8`, `st8w`) with
both coders, against tpulc's on the same input (pg1661[:50000] at 64
KiB blocks; st8w with coder 1 stores that block raw, as tpulc does, so
it also runs on pg1661[:100000] at 128 KiB, which it codes): the
containers are byte-identical, and each package decodes the other's.  Coder 1 on an ST sorter batches its blocks as on
the BWT; coder 2 is the adaptive binary coder (payload coder byte 2);
st8w codes the last column and the next-char stream and inverts on the
device, block by block.  The edges and hostile payloads are in
`test_torch_bsc_st_edges.py`."""

import pytest
import torch

from tpulc.codecs.bsclike import driver as td
from tpulc_torch.codecs.bsclike import driver as pd
from tpulc_torch.pipeline.container import Container

torch.set_num_threads(1)


def _pg(n):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read()[:n]


@pytest.mark.parametrize("sorter,coder", [
    (s, c) for s in ("st3", "st5", "st8", "st8w") for c in (1, 2)]
    + [("st8w_100k", 1)])
def test_st_container_equals_tpulc_and_cross_decodes(sorter, coder):
    n, bs = (100000, 131072) if sorter == "st8w_100k" else (50000, 65536)
    sorter = sorter.split("_")[0]
    data = _pg(n)
    ours = pd.compress(data, block_size=bs, sorter=sorter, coder=coder,
                       device="cpu")
    theirs = td.compress(data, block_size=bs, sorter=sorter, coder=coder)
    assert ours == theirs
    (payload,) = Container.from_bytes(ours).payloads
    k, wired = pd._sorter_k(sorter)
    flags, byte = payload[pd._HEAD.size - 2], payload[pd._HEAD.size - 1]
    assert byte == (pd.CODER_RANS if coder == 1 else pd.CODER_ABC)
    if wired and coder == 1 and n == 50000:
        assert flags == pd.FLAG_STORED   # twice the stream: no gain
    else:
        assert pd._sorter_k_of_flags(flags) == (k, wired)
        assert not flags & (pd.FLAG_STORED | pd.FLAG_ANCHORS)
    assert pd.decompress(theirs, device="cpu") == data
    assert td.decompress(ours) == data

"""The culzss match kernel (`csrc/culzss_match.cu`, through
`culzss.culzss_match`) against its plain version on the card, bit for
bit, on the edge packets of `test_torch_culzss_match.py`; and culzss
compress on the card against the CPU's bytes (marked `cuda`; they skip
on a machine without one).  No JAX.  On the card:
`python -m pytest --noconftest -q -m cuda tests/test_torch_culzss_cuda.py`."""

import numpy as np
import pytest
import torch
from test_torch_culzss_match import MATCH_CASES, match_group, match_packet, words

from tpulc_torch.codecs.lzss import culzss
from tpulc_torch.codecs.lzss.culzss import PCKT
from tpulc_torch.pipeline.registry import get_codec

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_equals_plain(packets: torch.Tensor) -> None:
    """One launch on packets (a CUDA tensor) against the plain version."""
    n = culzss.culzss_match.launches
    got = culzss.culzss_match(packets)
    torch.cuda.synchronize()
    assert culzss.culzss_match.launches == n + 1
    want = culzss.culzss_match_plain(packets)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.uint8
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", MATCH_CASES)
def test_match_kernel_equals_plain_on_each_case(cuda, name):
    pkt = match_packet(name, seed=11)[None, :]
    _kernel_equals_plain(torch.from_numpy(pkt).to(cuda))


@pytest.mark.parametrize("npackets", [1, 3, 863, 1024])
def test_match_kernel_equals_plain_on_a_group(cuda, npackets):
    group = match_group(npackets, seed=npackets)
    _kernel_equals_plain(torch.from_numpy(group).to(cuda))


def test_match_kernel_reads_rows_at_any_alignment(cuda):
    group = match_group(5, seed=2)
    buf = torch.zeros(group.size + 1, dtype=torch.uint8, device=cuda)
    buf[1:] = torch.from_numpy(group.reshape(-1)).to(cuda)
    packets = buf[1:].view(5, PCKT)
    assert packets.data_ptr() % 16 != 0
    _kernel_equals_plain(packets)


def test_encode_launches_once_a_group(cuda, monkeypatch):
    n = 2 * culzss.ENCODE_GROUP + 52
    block = torch.from_numpy(words(n * PCKT, seed=5))
    before = culzss.culzss_match.launches
    on_card = culzss.culzss_encode_block(block.to(cuda))
    assert culzss.culzss_match.launches == before + 3
    monkeypatch.setattr(culzss, "ENCODE_GROUP", 256)
    on_cpu = culzss.culzss_encode_block(block[: 300 * PCKT])
    for c, p in zip(on_card, on_cpu):
        assert torch.equal(c[:300].cpu(), p)


def test_compress_on_the_card_writes_the_cpus_bytes(cuda, monkeypatch):
    """3 MB of words: the same container from the card as from the CPU,
    with the card's match search in the kernel alone."""
    data = words(3_000_000, seed=6).tobytes()
    codec = get_codec("culzss")
    on_cpu = codec.compress(data, device="cpu", block_size=1 << 20)

    def no_plain_search(packets):
        raise AssertionError("the plain match search ran on the card")

    monkeypatch.setattr(culzss, "culzss_match_plain", no_plain_search)
    before = culzss.culzss_match.launches
    on_card = codec.compress(data, device="cuda", block_size=1 << 20)
    assert culzss.culzss_match.launches == before + 1   # 733 packets
    assert on_card == on_cpu
    assert codec.decompress(on_card, device="cuda") == data

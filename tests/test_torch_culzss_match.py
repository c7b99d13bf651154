"""The culzss encode's match search (`codecs/lzss/culzss.py`:
`culzss_match`, its plain version `culzss_match_plain`; on the card
`csrc/culzss_match.cu`) on edge packets, made from a numpy seed, with a
brute-force numpy definition of the pick.  The CPU tests hold the plain
version to the definition; `test_torch_culzss_cuda.py` holds the kernel
to the plain version on the same packets.  No JAX."""

import os

import numpy as np
import pytest
import torch

from portbench.traffic import generate
from tpulc_torch.codecs.lzss import culzss
from tpulc_torch.codecs.lzss.culzss import MAX_LEN, PCKT, WIN
from tpulc_torch.pipeline.registry import get_codec

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 32                     # tpulc's five int8 doubling steps
PERIODS = (1, 31, 32, 33, 127, 128)
MATCH_CASES = ("spaces", "zeros", *(f"period{p}" for p in PERIODS),
               "random", "words", "tail", "zeros_at_end")


def words(nbytes: int, seed: int) -> np.ndarray:
    """nbytes of pg1661's tokens drawn by their frequency (the
    benchmark's `word_draw` traffic)."""
    mix = {"kind": "word_draw", "file": "portbench/data/pg1661.txt",
           "size": nbytes, "objects": 1}
    return generate.objects(mix, seed, ROOT)[0]


def match_packet(name: str, seed: int = 0) -> np.ndarray:
    """One uint8[PCKT] packet of a case of MATCH_CASES:

    spaces, zeros   every byte 0x20 (the window's own byte), or 0
    period<p>       p random bytes repeated: every distance that is a
                    multiple of p runs to the cap
    random          uniform bytes: nearly every run is 0 or 1
    words           pg1661-like text, the benchmark's traffic
    tail            a block's last packet: 100 bytes of text, then the
                    zero padding
    zeros_at_end    text whose last 24 bytes and bytes 4,026-4,045 are
                    zero: runs that go on into the zeros past the
                    packet decide which distance wins
    """
    rng = np.random.default_rng(seed)
    if name == "spaces":
        return np.full(PCKT, 0x20, np.uint8)
    if name == "zeros":
        return np.zeros(PCKT, np.uint8)
    if name.startswith("period"):
        p = int(name[len("period"):])
        unit = rng.integers(0, 256, p, dtype=np.uint8)
        return np.tile(unit, -(-PCKT // p))[:PCKT]
    if name == "random":
        return rng.integers(0, 256, PCKT, dtype=np.uint8)
    pkt = words(PCKT, seed).copy()
    if name == "tail":
        pkt[100:] = 0
    elif name == "zeros_at_end":
        pkt[-24:] = 0
        pkt[-70:-50] = 0
    else:
        assert name == "words", name
    return pkt


def match_group(npackets: int, seed: int = 0) -> np.ndarray:
    """uint8[npackets, PCKT]: every case of MATCH_CASES in turn, then
    packets of words to fill the group."""
    cases = [match_packet(n, seed) for n in MATCH_CASES[:npackets]]
    rest = npackets - len(cases)
    if rest:
        cases.append(words(rest * PCKT, seed + 1).reshape(rest, PCKT))
    return np.vstack(cases).reshape(npackets, PCKT)


def match_reference(packets: np.ndarray):
    """The pick by its definition: best_len[i] = max over d = 1..128 of
    min(run_d(i), 32, d, 127), with run_d(i) the count of k from 0 with
    x[i+k] == x[i+k-d] (x after 128 spaces, zeros past the packet), and
    best_i[i] = d - 1 of the first d that reaches it; int64[G, PCKT]."""
    G = packets.shape[0]
    x = np.zeros((G, WIN + PCKT + CAP), np.uint8)
    x[:, :WIN] = 0x20
    x[:, WIN: WIN + PCKT] = packets
    ahead = WIN + np.arange(PCKT)[:, None] + np.arange(CAP)[None, :]
    best = np.zeros((G, PCKT), np.int64)
    best_i = np.zeros((G, PCKT), np.int64)
    for d in range(1, WIN + 1):
        eq = x[:, ahead] == x[:, ahead - d]               # [G, PCKT, CAP]
        run = np.cumprod(eq, axis=2).sum(axis=2)
        v = np.minimum(run, min(d, MAX_LEN))
        better = v > best
        best[better] = v[better]
        best_i[better] = d - 1
    return best, best_i


@pytest.mark.parametrize("name", MATCH_CASES)
def test_plain_match_equals_the_definition(name):
    pkt = match_packet(name)[None, :]
    best_len, best_i = culzss.culzss_match_plain(torch.from_numpy(pkt))
    assert best_len.dtype == best_i.dtype == torch.uint8
    want_len, want_i = match_reference(pkt)
    np.testing.assert_array_equal(best_len.numpy(), want_len[0:1])
    np.testing.assert_array_equal(best_i.numpy(), want_i[0:1])


def test_plain_match_of_a_group_is_its_rows():
    group = match_group(len(MATCH_CASES) + 2, seed=3)
    got = culzss.culzss_match(torch.from_numpy(group))
    for r in range(group.shape[0]):
        one = culzss.culzss_match_plain(torch.from_numpy(group[r: r + 1]))
        for g, w in zip(got, one):
            assert torch.equal(g[r: r + 1], w)


def test_wrapper_on_a_cpu_tensor_launches_nothing():
    before = culzss.culzss_match.launches
    pkt = torch.from_numpy(match_packet("words")[None, :])
    got = culzss.culzss_match(pkt)
    want = culzss.culzss_match_plain(pkt)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    data = words(3 * PCKT + 50, seed=4).tobytes()
    c = get_codec("culzss").compress(data, device="cpu", block_size=1 << 20)
    assert get_codec("culzss").decompress(c, device="cpu") == data
    assert culzss.culzss_match.launches == before


@pytest.mark.parametrize("bad", ["dtype", "width", "rank", "strided"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    pkts = torch.zeros((2, PCKT), dtype=torch.uint8)
    arg = {"dtype": pkts.to(torch.int32), "width": pkts[:, :PCKT - 1],
           "rank": pkts.reshape(-1), "strided": pkts[::2, :].expand(2, PCKT)
           }[bad]
    with pytest.raises(ValueError):
        culzss.culzss_match(arg)

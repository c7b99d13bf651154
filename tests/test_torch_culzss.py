"""The port's culzss codec (`codecs/lzss/culzss*.py`,
`primitives/parallel.orbit_flags_batched`) against tpulc's (through JAX
on the CPU), the serial gold (`tpulc/gold/culzss_gold`) and the
reference encoder's simulation (`tools/culzss_refsim.py`): the same
packets on tpulc's four cases and on a run that pins the 32-byte match
cap, the same containers and CLI bytes, cross-decoding both ways, and
the port's ValueErrors where tpulc asserts or silently misdecodes
(F9)."""

import os
import struct
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulc.cli.main import main as tpulc_main
from tpulc.codecs.lzss import culzss as tpulc_culzss
from tpulc.codecs.lzss import culzss_driver as tpulc_driver
from tpulc.gold import culzss_gold
from tpulc.primitives.parallel import orbit_flags as tpulc_orbit_flags
from tpulc_torch.cli.main import main as port_main
from tpulc_torch.codecs.lzss import culzss, culzss_driver as driver
from tpulc_torch.codecs.lzss.culzss import (
    CAP_OUT,
    PCKT,
    culzss_decode_block,
    culzss_encode_block,
)
from tpulc_torch.pipeline.container import Container
from tpulc_torch.pipeline.registry import CODEC_LZSS, get_codec
from tpulc_torch.primitives.parallel import orbit_flags, orbit_flags_batched

torch.set_num_threads(1)


def _pg(n, start=0):
    with open("tests/data/pg1661.txt", "rb") as f:
        return f.read()[start: start + n]


# tpulc's four cases (`tests/test_culzss.py`), its text read from the
# repo's copy of pg1661
CASES = {
    "text": lambda: _pg(PCKT * 3),
    "runs": lambda: (b"\x00" * 500 + b"abcabc" * 200 + b"\xff" * 900) * 4,
    "random": lambda: np.random.default_rng(9).integers(
        0, 256, size=PCKT * 2).astype(np.uint8).tobytes(),
    "single": lambda: b"z" * (PCKT * 2),
}


def _two_packets(name: str) -> bytes:
    data = CASES[name]()[: PCKT * 2]
    return data + bytes(PCKT * 2 - len(data))


def _encode(data: bytes):
    out, sizes, ntok = culzss_encode_block(
        torch.from_numpy(np.frombuffer(data, np.uint8).copy()))
    return out.numpy(), sizes.numpy(), ntok.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_orbit_equals_the_1d_orbit_row_by_row(seed):
    rng = np.random.default_rng(seed)
    n, rows = 300, 6
    steps = rng.integers(1, 9, size=(rows, n))
    jump = np.minimum(np.arange(n) + steps, n)
    jump_e = np.concatenate([jump, np.full((rows, 1), n)], axis=1)
    got = orbit_flags_batched(torch.from_numpy(jump_e), n, n).numpy()
    for r in range(rows):
        want = orbit_flags(torch.from_numpy(jump_e[r]), n, n).numpy()
        np.testing.assert_array_equal(got[r], want)
        np.testing.assert_array_equal(got[r], np.asarray(tpulc_orbit_flags(
            jnp.asarray(jump_e[r].astype(np.int32)), n, n)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_packets_equal_tpulc_and_decode_with_the_gold(name):
    data = _two_packets(name)
    out, sizes, ntok = _encode(data)
    t_out, t_sizes, t_ntok = (np.asarray(x) for x in
                              tpulc_culzss.culzss_encode_block(
                                  jnp.asarray(np.frombuffer(data, np.uint8))))
    np.testing.assert_array_equal(sizes, t_sizes)
    np.testing.assert_array_equal(ntok, t_ntok)
    np.testing.assert_array_equal(out, t_out)
    for j in range(2):
        if sizes[j] < PCKT:   # a raw packet is stored, not decoded
            pkt = out[j, : sizes[j]].tobytes()
            assert culzss_gold.decode_packet(pkt) == \
                data[j * PCKT: (j + 1) * PCKT]
    back, outl = culzss_decode_block(torch.from_numpy(out),
                                     torch.from_numpy(sizes))
    if name != "random":
        assert back.numpy().tobytes() == data
        assert outl.tolist() == [PCKT, PCKT]


def test_match_cap_is_32_bytes_as_tpulc():
    """tpulc's five int8 doubling steps cap a match at 32 bytes, below
    the 127 the length byte allows: 4,096 z's are a literal, then
    matches of 3, 6, 12 and 24 (each as long as its own distance allows
    with the nearest distance winning), then 32s; 282 bytes."""
    out, sizes, _ = _encode(b"z" * PCKT)
    assert int(sizes[0]) == 282
    pkt = out[0, :282]
    assert pkt[:8].tolist() == [7, 122, 122, 122, 3, 0, 6, 0]
    lens = [int(x) for x in pkt[4::2][:4]]
    assert lens == [3, 6, 12, 24]
    # every later match is 32 bytes long (flag bytes 0 break the pairs)
    body = culzss_gold.decode_packet(pkt.tobytes())
    assert body == b"z" * PCKT
    t_out, t_sizes, _ = tpulc_culzss.culzss_encode_block(
        jnp.asarray(np.frombuffer(b"z" * PCKT, np.uint8)))
    assert int(t_sizes[0]) == 282
    np.testing.assert_array_equal(out, np.asarray(t_out))


def test_nearest_distance_wins_ties_on_runs():
    """A period-3 run matches at distances 3, 6, 9, ...; the parse takes
    the nearest one (torch's `max` returns the first maximum)."""
    data = (b"abc" * 1400)[:PCKT]
    out, sizes, _ = _encode(data)
    pkt = out[0, : sizes[0]]
    # flags 0b111 (a, b, c literals), then matches (len, (pos - d) % 128)
    assert pkt[:4].tolist() == [7, ord("a"), ord("b"), ord("c")]
    assert pkt[4:6].tolist() == [3, 0]        # at 3, distance 3: slot 0
    assert culzss_gold.decode_packet(pkt.tobytes()) == data


@pytest.mark.parametrize("group", [1, 3])
def test_packet_groups_do_not_change_the_bytes(monkeypatch, group):
    """Encode and decode run a fixed count of packets at a time; the
    packets are independent, so any group size gives the same bytes."""
    data = _pg(PCKT * 7, 3000)
    block = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    whole = culzss_encode_block(block)
    monkeypatch.setattr(culzss, "ENCODE_GROUP", group)
    monkeypatch.setattr(culzss, "DECODE_GROUP", group + 1)
    for a, b in zip(culzss_encode_block(block), whole):
        assert torch.equal(a, b)
    back, outl = culzss_decode_block(whole[0], whole[1])
    assert back.numpy().tobytes() == data
    assert outl.tolist() == [PCKT] * 7


@pytest.mark.parametrize("start", [0, PCKT * 2, 100_000])
def test_port_decodes_gold_packets(start):
    data = _pg(PCKT * 2, start)
    pbuf = np.zeros((2, CAP_OUT), np.uint8)
    psizes = np.zeros(2, np.int64)
    for j in range(2):
        enc = culzss_gold.encode_packet(data[j * PCKT: (j + 1) * PCKT])
        pbuf[j, : len(enc)] = np.frombuffer(enc, np.uint8)
        psizes[j] = len(enc)
    back, outl = culzss_decode_block(torch.from_numpy(pbuf),
                                     torch.from_numpy(psizes))
    assert back.numpy().tobytes() == data
    assert outl.tolist() == [PCKT, PCKT]


def test_beats_reference_encoder_semantics():
    """tpulc's own parity bar, on the port's sizes: the full-window
    search compresses at least as well as the reference encoder's
    simulation, whose packets the gold decodes."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import culzss_refsim as refsim

    data = _pg(PCKT * 2)
    _, sizes, _ = _encode(data)
    for j in range(2):
        pkt = data[j * PCKT: (j + 1) * PCKT]
        ref_enc = refsim.aftercomp(refsim.encode_packet_pairs(pkt))
        assert culzss_gold.decode_packet(ref_enc) == pkt
        assert int(sizes[j]) <= len(ref_enc)


@pytest.mark.parametrize("data,block", [
    (lambda: _pg(150_000), 1 << 16),
    (lambda: _pg(PCKT * 3 + 17, 5000), 1 << 16),      # one short tail block
    (lambda: _pg(40_000) + bytes(300), 12_288),       # zeros into the tail
    (lambda: CASES["runs"]() + CASES["random"](), 8192),
    (lambda: b"", 1 << 16),
], ids=["pg150k", "short_tail", "zero_tail", "mixed_raw", "empty"])
def test_containers_equal_tpulc_and_cross_decode(data, block):
    data = data()
    ours = driver.compress(data, block_size=block, device="cpu")
    theirs = tpulc_driver.compress(data, block_size=block)
    assert ours == theirs
    assert driver.decompress(theirs, device="cpu") == data
    assert tpulc_driver.decompress(ours) == data


@pytest.mark.parametrize("n,block", [
    (0, 1 << 16), (1, 1 << 16), (PCKT, 1 << 16), (PCKT * 3 + 17, 1 << 16),
    (40_000, 12_288), (2 * 12_288, 12_288), (10_000, 5000),
])
def test_packet_grid_pads_each_block_to_whole_packets(n, block):
    arr = np.frombuffer(_pg(n), np.uint8)
    chunks = [arr[s: s + block] for s in range(0, max(n, 1), block)]
    counts = driver.block_packets(n, block)
    assert counts == [max(-(-len(c) // PCKT), 1) for c in chunks]
    want = np.concatenate([np.pad(c, (0, k * PCKT - len(c)))
                           for c, k in zip(chunks, counts)])
    grid = driver.packet_grid(arr, block, counts)
    assert grid.dtype == np.uint8 and np.array_equal(grid, want)


def test_registry_and_cli_write_tpulc_bytes(tmp_path, capsys):
    assert get_codec("culzss") is driver
    src = tmp_path / "in.txt"
    src.write_bytes(_pg(150_000))
    theirs, ours = tmp_path / "t.tplc", tmp_path / "p.tplc"
    argv = ["-c", "culzss", "-b", "65536"]
    assert tpulc_main(["compress", "-i", str(src), "-o", str(theirs),
                       *argv]) == 0
    assert port_main(["compress", "-i", str(src), "-o", str(ours), *argv,
                      "--device", "cpu"]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    capsys.readouterr()
    assert port_main(["info", "-i", str(ours)]) == 0
    assert '"codec": "culzss"' in capsys.readouterr().out
    back = tmp_path / "back.txt"
    assert port_main(["decompress", "-i", str(theirs), "-o", str(back),
                      "--device", "cpu"]) == 0
    assert back.read_bytes() == src.read_bytes()


# ------------------------------------------------------------------ F9

_F9_DATA = _pg(PCKT * 2 + 1000)


def _container() -> Container:
    return Container.from_bytes(
        driver.compress(_F9_DATA, block_size=1 << 16, device="cpu"))


def _with_payload(c: Container, payload: bytes) -> bytes:
    c.payloads[0] = payload
    c.comp_sizes[0] = len(payload)
    c.payload_adlers = []     # recomputed: the forgery passes them
    return c.to_bytes()


def _decompress(buf: bytes):
    return driver.decompress(buf, device="cpu")


def test_f9_wrong_codec_id_raises():
    c = _container()
    c.codec_id = CODEC_LZSS
    with pytest.raises(ValueError, match="not a culzss container"):
        _decompress(c.to_bytes())


def test_f9_size_table_overrun_raises():
    c = _container()
    p = c.payloads[0]
    with pytest.raises(ValueError, match="size table overruns"):
        _decompress(_with_payload(c, p[:8]))
    c = _container()
    with pytest.raises(ValueError, match="overrun the payload"):
        _decompress(_with_payload(c, p[:-5]))


def test_f9_packet_count_must_cover_the_block():
    c = _container()
    p = c.payloads[0]
    with pytest.raises(ValueError, match="2 packets for"):
        _decompress(_with_payload(c, struct.pack("<I", 2) + p[4:]))


def test_f9_raw_entry_other_than_a_packet_raises():
    c = _container()
    p = bytearray(c.payloads[0])
    struct.pack_into("<H", p, 4, 0x8000 | 100)
    with pytest.raises(ValueError, match="raw packet entry"):
        _decompress(_with_payload(c, bytes(p)))


def _with_first_packet(c: Container, first: bytes) -> bytes:
    """The container with its first block's first packet replaced."""
    p = c.payloads[0]
    (P,) = struct.unpack("<I", p[:4])
    sizes = list(struct.unpack(f"<{P}H", p[4: 4 + 2 * P]))
    rest = p[4 + 2 * P + sizes[0]:]
    sizes[0] = len(first)
    return _with_payload(c, struct.pack("<I", P)
                         + struct.pack(f"<{P}H", *sizes) + first + rest)


@pytest.mark.parametrize("cut", [1, 2, -1])
def test_f9_packet_of_the_wrong_length_raises(cut):
    """A first packet that decodes to 4,096 - cut bytes: tpulc fills the
    missing bytes with spaces (or drops the extra ones) and only the
    adler32 check objects; the port names the packet."""
    data = _F9_DATA[: PCKT - cut] if cut > 0 else _F9_DATA[: PCKT] + b"x"
    first = culzss_gold.encode_packet(data)
    with pytest.raises(ValueError, match="decodes to"):
        _decompress(_with_first_packet(_container(), first))


def test_f9_zero_length_match_raises():
    """A first packet of literals led by a match of length 0: it decodes
    to 4,096 bytes, but two of its records share output position 0
    (which one lands is unspecified in tpulc)."""
    pkt = _F9_DATA[:PCKT]
    first = bytes([0xFE, 0, 5]) + pkt[:7]
    for g in range(7, PCKT, 8):
        lits = pkt[g: g + 8]
        first += bytes([(1 << len(lits)) - 1]) + lits
    assert len(first) <= CAP_OUT
    with pytest.raises(ValueError, match="zero-length match"):
        _decompress(_with_first_packet(_container(), first))

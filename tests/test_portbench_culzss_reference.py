"""The benchmark's plain decoder of the culzss container
(`portbench/reference/culzss.py`) against the port's containers on the
CPU: seeded inputs at small sizes, containers broken so that every
checksum still holds and only the format's checks can tell, a small
CPU run of the culzss cell with the control and each planted fault, and
the decoder's independence from the program under test."""

import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from portbench.reference import culzss as ref
from portbench.reference.common import FormatError
from portbench.traffic import generate
from tpulc_torch.pipeline.registry import get_codec

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCKT = 4096


def words(n: int, seed: int) -> bytes:
    """n bytes of pg1661's tokens drawn by their frequency, as the
    cell's traffic draws them."""
    mix = {"kind": "word_draw", "size": n, "objects": 1,
           "file": "portbench/data/pg1661.txt"}
    return generate.objects(mix, seed, ROOT)[0].tobytes()


def compress(data: bytes, **kw) -> bytes:
    return get_codec("culzss").compress(data, device="cpu", **kw)


def tokens(packet: bytes):
    """(kind, length) of each token of a coded packet, walked serially:
    ("lit", 1) or ("match", length)."""
    out, i, k, flag = [], 0, 0, 0
    while i < len(packet):
        if k % 8 == 0:
            flag, i = packet[i], i + 1
        if flag >> (k % 8) & 1:
            out.append(("lit", 1))
            i += 1
        else:
            out.append(("match", packet[i]))
            i += 2
        k += 1
    return out


RNG = np.random.default_rng(27)
CASES = {
    "words_1m_blocks": (words(2_200_000, 1), {}),
    "words_64k_blocks": (words(300_000, 2), {"block_size": 65_536}),
    "words_12k_blocks": (words(100_000, 3), {"block_size": 12_288}),
    "tail_not_a_packet": (words(3 * PCKT + 1_234, 4),
                          {"block_size": 65_536}),
    "random_raw_packets": (RNG.integers(0, 256, 30_000, dtype=np.uint8)
                           .tobytes() + words(20_000, 5),
                           {"block_size": 16_384}),
    "zs_hit_the_32_byte_cap": (b"z" * PCKT, {}),
    "one_byte": (b"a", {}),
    "empty": (b"", {}),
}


def blocks_of(c: bytes):
    """-> each payload of the container as a bytearray."""
    (n,) = struct.unpack_from("<I", c, 20)
    sizes = np.frombuffer(c, "<u4", n, 32)
    off = 32 + 8 * n
    out = []
    for s in sizes:
        out.append(bytearray(c[off: off + int(s)]))
        off += int(s)
    return out


def packets_of(payload: bytes):
    """-> (size table entries, each packet's bytes)."""
    (P,) = struct.unpack_from("<I", payload)
    entries = list(struct.unpack_from(f"<{P}H", payload, 4))
    off, pk = 4 + 2 * P, []
    for e in entries:
        n = e & 0x7FFF
        pk.append(bytes(payload[off: off + n]))
        off += n
    return entries, pk


def payload_from(entries, pk) -> bytearray:
    return bytearray(struct.pack("<I", len(entries))
                     + struct.pack(f"<{len(entries)}H", *entries)
                     + b"".join(pk))


def reseal(c: bytes, payloads) -> bytes:
    """The container with these payloads and their sizes and adler32s
    written anew (the header, its block count and the data adler32
    kept)."""
    sizes = np.array([len(p) for p in payloads], "<u4").tobytes()
    adlers = np.array([zlib.adler32(bytes(p)) & 0xFFFFFFFF
                       for p in payloads], "<u4").tobytes()
    return c[:32] + sizes + adlers + b"".join(bytes(p) for p in payloads)


def test_container_header_is_as_the_helpers_read_it():
    c = compress(words(10_000, 6), block_size=4_096)
    assert reseal(c, blocks_of(c)) == c
    assert struct.unpack_from("<4sB", c) == (b"TPLC", 3)
    assert struct.unpack_from("<B", c, 5)[0] == ref.CODEC


@pytest.mark.parametrize("case", sorted(CASES))
def test_reads_the_port(case):
    data, kw = CASES[case]
    c = compress(data, **kw)
    assert ref.decode(c) == data
    assert get_codec("culzss").decompress(c, device="cpu") == data
    entries = [e for p in blocks_of(c) for e in packets_of(p)[0]]
    raw = [e & 0x8000 != 0 for e in entries]
    if case == "random_raw_packets":
        assert any(raw) and not all(raw)
    else:
        assert not any(raw)
    if case == "zs_hit_the_32_byte_cap":
        _, (pk,) = packets_of(blocks_of(c)[0])
        assert max(n for kind, n in tokens(pk) if kind == "match") == 32


def packet(toks) -> bytes:
    """A coded packet of tokens (1, byte) or (0, bytes([length,
    offset])), a flag byte before each 8."""
    out = bytearray()
    for g in range(0, len(toks), 8):
        grp = toks[g: g + 8]
        out.append(sum(bit << j for j, (bit, _) in enumerate(grp)))
        for _, b in grp:
            out += b
    return bytes(out)


def lits(data: bytes):
    return [(1, data[i: i + 1]) for i in range(len(data))]


def with_matches(data: bytes):
    """Tokens of `data`: a 3-byte match of the bytes 8 back wherever
    they repeat, else a literal."""
    toks, i = [], 0
    while i < len(data):
        if i >= 8 and data[i: i + 3] == data[i - 8: i - 5]:
            toks.append((0, bytes([3, (i - 8) % 128])))
            i += 3
        else:
            toks.append((1, data[i: i + 1]))
            i += 1
    return toks


def _with_first_packet(c: bytes, first: bytes, raw: bool = False) -> bytes:
    ps = blocks_of(c)
    entries, pk = packets_of(ps[0])
    entries[0] = (0x8000 if raw else 0) | len(first)
    pk[0] = first
    ps[0] = payload_from(entries, pk)
    return reseal(c, ps)


BROKEN = {
    # fault -> the message the format's check raises
    "packet_count_short": "packets for",
    "packet_count_long": "packets for",
    "size_table_overruns": "size table overruns",
    "bodies_overrun": "do not fill their payload",
    "bytes_after_the_packets": "do not fill their payload",
    "raw_entry_of_4095": "raw packet other than",
    "raw_entry_of_4097": "raw packet other than",
    "ends_inside_a_match": "ends inside a token",
    "flag_byte_with_no_token": "ends inside a token",
    "decodes_to_4095": "wrong length",
    "decodes_to_4097": "wrong length",
    "last_packet_one_past_its_tail": "wrong length",
    "zero_length_match": "match of length 0",
    "payload_adler32": "payload adler32",
    "data_adler32": "decoded length or data adler32",
}
DATA = words(3 * PCKT + 1_000, 7)


def _break(fault: str) -> bytes:
    c = compress(DATA, block_size=65_536)
    ps = blocks_of(c)
    p = ps[0]
    entries, pk = packets_of(p)
    if fault == "packet_count_short":
        struct.pack_into("<I", p, 0, len(entries) - 1)
    elif fault == "packet_count_long":
        ps[0] = payload_from(entries + [0], pk + [b""])
    elif fault == "size_table_overruns":
        ps[0] = p[: 4 + 2 * len(entries) - 1]
    elif fault == "bodies_overrun":
        del p[-5:]
    elif fault == "bytes_after_the_packets":
        p += b"\x00"
    elif fault in ("raw_entry_of_4095", "raw_entry_of_4097"):
        n = PCKT - 1 if fault.endswith("4095") else PCKT + 1
        return _with_first_packet(c, DATA[:n], raw=True)
    elif fault == "ends_inside_a_match":
        # a last token that is a match, cut after its length byte
        first = packet(lits(DATA[:PCKT - 3]) + [(0, bytes([3, 9]))])
        return _with_first_packet(c, first[:-1])
    elif fault == "flag_byte_with_no_token":
        return _with_first_packet(c, packet(lits(DATA[:PCKT])) + b"\xff")
    elif fault == "decodes_to_4095":
        return _with_first_packet(c, packet(with_matches(DATA[:PCKT - 1])))
    elif fault == "decodes_to_4097":
        return _with_first_packet(c, packet(with_matches(DATA[:PCKT]
                                                         + b"x")))
    elif fault == "last_packet_one_past_its_tail":
        tail = len(DATA) - (len(entries) - 1) * PCKT
        pk[-1] = packet(lits(DATA[-tail:] + b"x"))
        entries[-1] = len(pk[-1])
        ps[0] = payload_from(entries, pk)
    elif fault == "zero_length_match":
        # a match of length 0 first: the rest of the packet's literals
        # still give 4,096 bytes
        first = packet([(0, bytes([0, 5]))] + lits(DATA[:PCKT]))
        return _with_first_packet(c, first)
    elif fault == "payload_adler32":
        b = bytearray(c)
        b[-3] ^= 1
        return bytes(b)
    elif fault == "data_adler32":
        # the first token, a literal, changed: a sound stream, the
        # payload's adler32 made whole, the data's not
        assert tokens(pk[0])[0] == ("lit", 1)
        first = bytearray(pk[0])
        first[1] ^= 0x01
        return _with_first_packet(c, bytes(first))
    return reseal(c, ps)


@pytest.mark.parametrize("fault", sorted(BROKEN))
def test_broken_containers_are_refused(fault):
    with pytest.raises(FormatError, match=BROKEN[fault]):
        ref.decode(_break(fault))


def test_hand_made_packets_read_back():
    """The packets the broken cases are made from are sound: literals
    alone, and literals with 3-byte matches 8 back."""
    toks = with_matches(DATA[:PCKT])
    assert any(bit == 0 for bit, _ in toks)
    for t in (lits(DATA[:PCKT]), toks):
        c = _with_first_packet(compress(DATA, block_size=65_536), packet(t))
        assert ref.decode(c) == DATA


def test_a_match_reads_the_ring_as_it_stood_before_it():
    """A match longer than its distance reads the ring as it stood
    before the token (CULZSS's copy), not the bytes it writes itself,
    so slots not yet written read as spaces; the last packet may give
    just its block's tail."""
    want = b"abcd" + b"abcd    " + b"   "
    toks = lits(b"abcd") + [(0, bytes([8, 0])), (0, bytes([3, 120]))]
    tail = DATA[: 1_000 - len(want)]
    data = DATA[:PCKT] + want + tail
    c = compress(data, block_size=65_536)
    ps = blocks_of(c)
    entries, pk = packets_of(ps[0])
    pk[-1] = packet(toks + lits(tail))
    entries[-1] = len(pk[-1])
    ps[0] = payload_from(entries, pk)
    assert ref.decode(reseal(c, ps)) == data


SMALL = {"compress": {"block_size": 65_536},
         "traffic": {"size": 150_000, "objects": 2}}
CELL_RUNS = """
import json, sys
from portbench import control, run
SEED = 2**31 + 2727
small = json.loads(sys.argv[1])
out = {}
for fault in ("sound",) + control.FAULTS:
    wrap = None if fault == "sound" else (
        lambda c, f=fault: control.Faulty(c, f, SEED))
    code, res = run.run_cell("culzss-1m.words-100m", SEED, 0.2, 0,
                             device="cpu", codec_wrap=wrap, overrides=small)
    out[fault] = {"code": code, "result": res}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cell_runs():
    # a process of its own: the benchmark refuses to run beside jax,
    # which the test session has loaded
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, "-c", CELL_RUNS, json.dumps(SMALL)],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_small_cpu_run_of_the_cell_is_correct(cell_runs):
    run = cell_runs["sound"]
    assert run["code"] == 0
    res = run["result"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert res["metrics"]["ratio"]["value"] > 1


@pytest.mark.parametrize("fault", ["lossy", "flip_container", "flip_output",
                                   "half_input", "half_output"])
def test_each_fault_of_the_control_is_not_correct(cell_runs, fault):
    from portbench import control

    assert fault in control.FAULTS
    run = cell_runs[fault]
    assert run["code"] == 0
    res = run["result"]
    assert not res["correct"] and res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


IMPORT_ALONE = """
import sys
import portbench.reference.culzss as ref
with open(sys.argv[1], "rb") as f:
    c = f.read()
with open(sys.argv[2], "rb") as f:
    want = f.read()
assert ref.decode(c) == want
bad = [m for m in sys.modules if m.split(".")[0] in
       ("tpulc", "tpulc_torch", "jax")]
print(bad)
sys.exit(1 if bad else 0)
"""


def test_decodes_importing_nothing_of_the_program(tmp_path):
    data = words(50_000, 8)
    (tmp_path / "c").write_bytes(compress(data, block_size=16_384))
    (tmp_path / "want").write_bytes(data)
    p = subprocess.run([sys.executable, "-c", IMPORT_ALONE,
                        str(tmp_path / "c"), str(tmp_path / "want")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


@pytest.mark.cuda
def test_the_card_reads_and_refuses_as_the_cpu():
    """On the card the walk runs as a CUDA graph: the same bytes read
    back, and every broken case refused with the same message."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case in sorted(CASES):
        data, kw = CASES[case]
        assert ref.decode(compress(data, **kw), "cuda") == data, case
    for fault in sorted(BROKEN):
        with pytest.raises(FormatError, match=BROKEN[fault]):
            ref.decode(_break(fault), "cuda")

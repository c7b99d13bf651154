"""The port's tracer (`tpulc_torch/utils/timing.py`) on the CPU: spans
nest under each call's root with their call and block ids, the coarse
stages keep their names and are the only spans that synchronise, the
timer off records nothing, the profiler's `stage:` ranges are the
record, the waits of an input are fixed, and the benchmark's traced
run reads the six metrics the tracer feeds (and, in the huffman and
culzss cells, those of their stages); culzss's waits are pinned site by
site and its counters agree with the containers it writes."""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpulc_torch.pipeline.registry import get_codec
from tpulc_torch.utils import timing

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

with open("tests/data/pg1661.txt", "rb") as _f:
    DATA = _f.read()[:60_000] * 3          # 3 blocks of bz or bsc
CODECS = {
    "bz": {"block_size": 65536},
    "bsc": {"block_size": 65536, "coder": 1, "filter_mode": "none"},
    "huffman": {"block_size": 1024},       # 176 blocks: 2 groups
    "culzss": {"block_size": 65536},       # 44 packets: 1 group
}
# the span of a block (huffman: of a group, indexed by its first block)
# and the block indices a round trip of DATA gives it
BLOCK_SPANS = {"bz": ("bz.block", [0, 1, 2]), "bsc": ("bsc.block", [0, 1, 2]),
               "huffman": ("huffman.group", [0, 128]),
               "culzss": ("culzss.group", [0])}
TODAY = {
    "bz": {"bz.transform", "bz.tables", "bz.entropy", "bz.pull", "bz.walk",
           "bz.inverse"},
    "bsc": {"bsc.lzp", "bsc.transform", "bsc.rans", "bsc.rans.decode",
            "bsc.inverse", "bsc.lzp.decode"},
    "huffman": {"huffman.encode", "huffman.pull", "huffman.parse",
                "huffman.decode"},
    "culzss": {"culzss.grid", "culzss.candidates", "culzss.doubling",
               "culzss.parse", "culzss.pack", "culzss.pull",
               "culzss.container", "culzss.payloads", "culzss.records",
               "culzss.rounds", "culzss.out", "culzss.verify"},
}
# the waits of DATA's round trip, (compress, decompress)
WAITS = {"bz": (35, 21), "bsc": (40, 13), "huffman": (8, 10),
         "culzss": (4, 19)}


def round_trip(name, timer_on=True):
    """Compress then decompress DATA -> (timer or None, output)."""
    codec = get_codec(name)
    timer = timing.enable() if timer_on else None
    try:
        c = codec.compress(DATA, device="cpu", **CODECS[name])
        out = codec.decompress(c, device="cpu")
    finally:
        timing.disable()
    assert out == DATA
    return timer, out


def records(timer):
    return [s for s in timer.spans if s.name not in (timing.GC, timing.SYNC)]


@pytest.mark.parametrize("name", sorted(CODECS))
def test_spans_nest_under_each_call_with_block_ids(name):
    timer, _ = round_trip(name)
    spans = timer.spans
    roots = [s for s in records(timer) if s.parent < 0]
    assert [s.name for s in roots] == [f"{name}.compress",
                                       f"{name}.decompress"]
    assert roots[0].call < roots[1].call
    for s in spans:
        if s.parent < 0:
            continue
        up = spans[s.parent]
        assert up.index < s.index and up.call == s.call
        assert up.start <= s.start <= s.end <= up.end
    block_span, block_ids = BLOCK_SPANS[name]
    for root in roots:
        mine = [s for s in spans if s.call == root.call]
        blocks = [s for s in mine if s.name == block_span]
        assert sorted({s.block for s in blocks}) == block_ids
        for s in mine:
            # a span carries the block of the nearest block span above
            # it, and no block outside one
            up, want = s, None
            while up.parent >= 0:
                up = spans[up.parent]
                if up.name == block_span:
                    want = up.block
                    break
            if s.name == block_span:
                want = s.block
            assert s.block == want, (s.name, s.block, want)


# each huffman span's parent in a round trip (`huffman/driver.py`,
# `huffman/decode.py`): the sub-spans sit inside their coarse stage
HUFFMAN_PARENTS = {
    "compress": {
        "huffman.group": "huffman.compress",
        "huffman.encode": "huffman.group",
        "huffman.upload": "huffman.encode",
        "huffman.histogram": "huffman.encode",
        "huffman.lengths": "huffman.encode",
        "huffman.codes": "huffman.encode",
        "huffman.pack": "huffman.encode",
        "huffman.pull": "huffman.group",
        "huffman.payload": "huffman.group",
        "huffman.adler32": "huffman.compress",
        "huffman.container": "huffman.compress",
    },
    "decompress": {
        "huffman.container": "huffman.decompress",
        "huffman.group": "huffman.decompress",
        "huffman.parse": "huffman.group",
        "huffman.upload": "huffman.parse",
        "huffman.decode": "huffman.group",
        "huffman.tables": "huffman.decode",
        "huffman.walk": "huffman.decode",
        "huffman.symbols": "huffman.decode",
        "huffman.pull": "huffman.group",
        "huffman.join": "huffman.decompress",
        "huffman.adler32": "huffman.decompress",
    },
}


def test_huffman_spans_sit_inside_their_coarse_stages():
    timer, _ = round_trip("huffman")
    spans = timer.spans
    roots = [s for s in records(timer) if s.parent < 0]
    assert [s.name for s in roots] == ["huffman.compress",
                                       "huffman.decompress"]
    for root, direction in zip(roots, ("compress", "decompress")):
        mine = [s for s in records(timer)
                if s.call == root.call and s is not root]
        parents = {}
        for s in mine:
            parents.setdefault(s.name, set()).add(spans[s.parent].name)
        assert parents == {k: {v} for k, v in
                           HUFFMAN_PARENTS[direction].items()}
        groups = [s for s in mine if s.name == "huffman.group"]
        assert [g.block for g in groups] == [0, 128]
        for s in mine:
            if s.name in HUFFMAN_PARENTS[direction] and \
                    spans[s.parent].name != root.name:
                assert s.block in (0, 128)
    assert timer.counts["huffman.encode"] == timer.counts["huffman.decode"] \
        == 2
    # timed at the coarse stages' edges only: a sub-span's seconds lie
    # inside its stage's
    for sub, stage in (("huffman.walk", "huffman.decode"),
                       ("huffman.pack", "huffman.encode")):
        assert timer.stages[sub] <= timer.stages[stage]


@pytest.mark.parametrize("name", sorted(CODECS))
def test_todays_stage_names_keep_their_totals(name):
    timer, _ = round_trip(name)
    names = {s.name for s in records(timer)}
    # the coarse stages are there, and no new span took a coarse name
    assert names & timing.STAGES == TODAY[name]
    for stage in TODAY[name]:
        mine = [s for s in timer.spans if s.name == stage]
        assert timer.counts[stage] == len(mine)
        assert timer.stages[stage] == pytest.approx(
            sum(s.end - s.start for s in mine) * 1e-9)
    assert set(timer.report()) == names | set(
        n for n in (timing.GC,) if n in timer.stages)


def test_timer_off_records_nothing_and_never_synchronises(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(1))
    round_trip("bz", timer_on=False)
    assert calls == [] and timing._TRACE.open == []
    assert timing.stage("bz.transform") is timing._NULL
    assert timing.wait(int, torch.tensor(7)) == 7
    timer, _ = round_trip("bz")
    syncs = [s for s in timer.spans if s.name == timing.SYNC]
    coarse = [s for s in timer.spans if s.name in timing.STAGES]
    # one synchronisation at each edge of a coarse stage, and none else
    assert len(calls) == len(syncs) == 2 * len(coarse)
    for s in syncs:
        up = timer.spans[s.parent]
        assert up.name in timing.STAGES or any(
            c.parent == up.index and c.name in timing.STAGES
            for c in timer.spans)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_profiler_ranges_are_the_record(name):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        timer, _ = round_trip(name)
    events = [e for e in prof.events()
              if e.name.startswith(timing.PROFILER_PREFIX)]
    events.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
    spans = records(timer)
    assert [e.name[len(timing.PROFILER_PREFIX):] for e in events] == \
        [s.name for s in spans]

    def parent(e):
        up = e.cpu_parent
        while up is not None and not up.name.startswith(
                timing.PROFILER_PREFIX):
            up = up.cpu_parent
        return None if up is None else up.name[len(timing.PROFILER_PREFIX):]

    assert [parent(e) for e in events] == [
        timer.spans[s.parent].name if s.parent >= 0 else None
        for s in spans]


@pytest.mark.parametrize("name", sorted(CODECS))
def test_waits_of_an_input_are_fixed(name):
    counts = []
    for _ in range(2):
        codec = get_codec(name)
        per_direction = []
        for direction in ("compress", "decompress"):
            timer = timing.enable()
            try:
                if direction == "compress":
                    c = codec.compress(DATA, device="cpu", **CODECS[name])
                else:
                    codec.decompress(c, device="cpu")
            finally:
                timing.disable()
            sites = {k: v[0] for k, v in timer.sites.items()}
            assert timer.stages[timing.WAITS] == sum(sites.values()) == \
                sum(s.waits for s in timer.spans)
            per_direction.append(sites)
        counts.append(per_direction)
    assert counts[0] == counts[1]
    assert tuple(sum(d.values()) for d in counts[0]) == WAITS[name]


# culzss's waits of DATA's round trip, site by site: (file, the line's
# text) -> waits; a multi-line call is keyed by the line it starts on
CULZSS_SITES = {
    "compress": {
        ("culzss_driver.py", "packets = timing.upload(grid, dev)"): 1,
        ("culzss_driver.py",
         "bodies = timing.wait(torch.Tensor.cpu, timing.wait("): 2,
        ("culzss_driver.py",
         "meta = timing.wait(torch.Tensor.cpu, torch.stack("): 1,
    },
    "decompress": {
        ("culzss_driver.py", "psz = timing.upload(psizes, dev)"): 1,
        ("culzss_driver.py", "timing.wait(torch.Tensor.__setitem__, pbuf,"): 1,
        ("culzss_driver.py",
         "timing.upload(np.concatenate([x[2] for x in parts]),"): 1,
        ("culzss.py",
         "ones = timing.upload(torch.tensor(_POPCOUNT), dev)[f]"): 1,
        ("culzss.py", "if timing.wait(bool, zero_len.any()):"): 1,
        ("culzss.py", "if timing.wait(torch.equal, nxt, src, nbytes=1):"): 7,
        ("culzss_driver.py", "want_t = timing.upload(want, dev)"): 1,
        ("culzss_driver.py", "raw_t = timing.upload(raw, dev)"): 1,
        ("culzss_driver.py", "timing.wait(torch.Tensor.__setitem__, last,"): 1,
        ("culzss_driver.py", "timing.upload(ends, dev), True, nbytes=1)"): 1,
        ("culzss_driver.py", "if timing.wait(bool, bad.any()):"): 1,
        ("culzss_driver.py",
         "got = timing.wait(torch.Tensor.cpu, timing.wait("): 2,
    },
}


def _site_text(site: str):
    path, line = site.rsplit(":", 1)
    with open(os.path.join(timing._PACKAGE, path)) as f:
        text = f.read().splitlines()[int(line) - 1].strip()
    return os.path.basename(path), text


def test_culzss_waits_are_pinned_site_by_site():
    codec = get_codec("culzss")
    for direction in ("compress", "decompress"):
        timer = timing.enable()
        try:
            if direction == "compress":
                c = codec.compress(DATA, device="cpu", **CODECS["culzss"])
            else:
                assert codec.decompress(c, device="cpu") == DATA
        finally:
            timing.disable()
        got = {}
        for site, row in timer.sites.items():
            key = _site_text(site)
            got[key] = got.get(key, 0) + row[0]
        assert got == CULZSS_SITES[direction]


def _packets(container: bytes):
    """-> (raw flags, each coded packet's tokens and matches), read from
    the container's size tables and a serial walk of each packet."""
    (n,) = struct.unpack_from("<I", container, 20)
    sizes = struct.unpack_from(f"<{n}I", container, 32)
    off, raw, counts = 32 + 8 * n, [], []
    for size in sizes:
        (P,) = struct.unpack_from("<I", container, off)
        entries = struct.unpack_from(f"<{P}H", container, off + 4)
        p = off + 4 + 2 * P
        for e in entries:
            raw.append(bool(e & 0x8000))
            body = container[p: p + (e & 0x7FFF)]
            p += e & 0x7FFF
            if raw[-1]:
                continue
            i = k = toks = matches = flag = 0
            while i < len(body):
                if k % 8 == 0:
                    flag, i = body[i], i + 1
                lit = flag >> (k % 8) & 1
                i += 1 if lit else 2
                toks, matches, k = toks + 1, matches + (not lit), k + 1
            counts.append((toks, matches))
        off += size
    return raw, counts


def test_culzss_counters_equal_what_the_codec_wrote(monkeypatch):
    from tpulc_torch.codecs.lzss import culzss

    # 16 packets a group: 2 encode and 2 decode groups, each a span
    monkeypatch.setattr(culzss, "ENCODE_GROUP", 16)
    monkeypatch.setattr(culzss, "DECODE_GROUP", 16)
    rng = np.random.default_rng(5)
    data = DATA[:100_000] + rng.integers(0, 256, 20_000, np.uint8).tobytes()
    codec = get_codec("culzss")
    before = culzss.culzss_decode_block.rounds
    timer = timing.enable()
    try:
        c = codec.compress(data, device="cpu", **CODECS["culzss"])
        assert codec.decompress(c, device="cpu") == data
    finally:
        timing.disable()
    raw, counts = _packets(c)
    assert 0 < sum(raw) < len(raw)
    st = timer.stages
    assert st["#culzss_packets"] == len(raw) == 30
    assert st["#culzss_raw_packets"] == sum(raw)
    assert st["#culzss_tokens"] == sum(t for t, _ in counts)
    assert st["#culzss_matches"] == sum(m for _, m in counts) > 0
    assert st["#culzss_rounds"] == culzss.culzss_decode_block.rounds \
        - before > 0
    roots = [s for s in records(timer) if s.parent < 0]
    assert [s.name for s in roots] == ["culzss.compress", "culzss.decompress"]
    # one call id a call, every span of it under its root
    assert roots[0].call != roots[1].call
    assert {s.call for s in timer.spans} == {r.call for r in roots}
    for root in roots:
        mine = [s for s in timer.spans if s.call == root.call]
        groups = [s for s in mine if s.name == "culzss.group"]
        assert [g.block for g in groups] == [0, 16]
        assert all(timer.spans[g.parent] is root for g in groups)
        for s in mine:
            up = s
            while up.parent >= 0:
                up = timer.spans[up.parent]
            assert up is root


def test_culzss_with_the_timer_off_keeps_no_total(monkeypatch):
    from tpulc_torch.codecs.lzss import culzss

    kept = []
    monkeypatch.setattr(timing, "add_totals", lambda *a: kept.append(a))
    stacked = []
    real_stack = torch.stack
    monkeypatch.setattr(torch, "stack",
                        lambda *a, **k: stacked.append(1) or real_stack(*a,
                                                                        **k))
    before = culzss.culzss_decode_block.rounds
    codec = get_codec("culzss")
    c = codec.compress(DATA, device="cpu", **CODECS["culzss"])
    assert codec.decompress(c, device="cpu") == DATA
    assert not timing.counting() and kept == [] and stacked == []
    assert culzss.culzss_decode_block.rounds - before == \
        CULZSS_SITES["decompress"][
            ("culzss.py", "if timing.wait(torch.equal, nxt, src, nbytes=1):")]


SMALL = {
    "bz.words-25m": {"compress": {"block_size": 65_536},
                     "traffic": {"size": 100_000, "objects": 2}},
    "bsc-e1.words-25m": {"compress": {"block_size": 32_768},
                         "traffic": {"size": 50_000, "objects": 2}},
    "huffman-1m.words-100m": {"compress": {"block_size": 65_536},
                              "traffic": {"size": 200_000, "objects": 2}},
    "culzss-1m.words-100m": {"compress": {"block_size": 65_536},
                             "traffic": {"size": 100_000, "objects": 2}},
}
NEW_METRICS = [f"{m}.{d}" for m in ("host_waits_per_MB", "host_wait_s_per_GB",
                                    "entry_s_per_GB")
               for d in ("compress", "decompress")]
CELL_METRICS = {"huffman-1m.words-100m": [
    "huffman_encode_s_per_GB.compress", "huffman_parse_s_per_GB.decompress",
    "huffman_decode_s_per_GB.decompress", "huffman_pull_s_per_GB.decompress"],
    "culzss-1m.words-100m": [
    "culzss_match_s_per_GB.compress", "culzss_parse_s_per_GB.compress",
    "culzss_host_s_per_GB.compress", "culzss_decode_s_per_GB.decompress",
    "culzss_host_s_per_GB.decompress"]}


TRACED_RUN = """
import json, sys
from portbench import run
code, res = run.run_cell(sys.argv[1], 2**31 + 5, 0.3, 1, device="cpu",
                         overrides=json.loads(sys.argv[2]))
print(json.dumps({"code": code, "result": res}))
"""


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_cpu_run_reads_the_new_metrics(cell):
    # a process of its own: the benchmark refuses to run beside jax,
    # which the test session has loaded
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, "-c", TRACED_RUN, cell,
                        json.dumps(SMALL[cell])], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["code"] == 0 and out["result"]["correct"]
    for m in NEW_METRICS + CELL_METRICS.get(cell, []):
        assert out["result"]["metrics"][m]["value"] > 0, m


def test_cli_timings_prints_the_totals_then_the_spans(tmp_path, capsys):
    from tpulc_torch.cli.main import main

    src = tmp_path / "in"
    src.write_bytes(DATA)
    assert main(["compress", "-c", "bz", "-i", str(src), "-o",
                 str(tmp_path / "out"), "-b", "65536", "--device", "cpu",
                 "--timings"]) == 0
    totals, trace = [json.loads(x)
                     for x in capsys.readouterr().err.splitlines()]
    assert totals["bz.transform"]["calls"] == 3
    assert "MBps" not in totals["bz.transform"]
    assert [s["name"] for s in trace["spans"]
            if s["parent"] < 0 and s["name"] != timing.GC] == ["bz.compress"]
    assert trace["totals"][timing.WAITS] == WAITS["bz"][0]

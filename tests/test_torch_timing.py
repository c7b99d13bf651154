"""The port's tracer (`tpulc_torch/utils/timing.py`) on the CPU: spans
nest under each call's root with their call and block ids, the coarse
stages keep their names and are the only spans that synchronise, the
timer off records nothing, the profiler's `stage:` ranges are the
record, the waits of an input are fixed, and the benchmark's traced
run reads the six metrics the tracer feeds (and, in the huffman cell,
the four of the huffman stages)."""

import json
import os
import subprocess
import sys

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
}
# the span of a block (huffman: of a group, indexed by its first block)
# and the block indices a round trip of DATA gives it
BLOCK_SPANS = {"bz": ("bz.block", [0, 1, 2]), "bsc": ("bsc.block", [0, 1, 2]),
               "huffman": ("huffman.group", [0, 128])}
TODAY = {
    "bz": {"bz.transform", "bz.tables", "bz.entropy", "bz.pull", "bz.walk",
           "bz.inverse"},
    "bsc": {"bsc.lzp", "bsc.transform", "bsc.rans", "bsc.rans.decode",
            "bsc.inverse", "bsc.lzp.decode"},
    "huffman": {"huffman.encode", "huffman.pull", "huffman.parse",
                "huffman.decode"},
}
# the waits of DATA's round trip, (compress, decompress)
WAITS = {"bz": (35, 21), "bsc": (40, 13), "huffman": (8, 10)}


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


SMALL = {
    "bz.words-25m": {"compress": {"block_size": 65_536},
                     "traffic": {"size": 100_000, "objects": 2}},
    "bsc-e1.words-25m": {"compress": {"block_size": 32_768},
                         "traffic": {"size": 50_000, "objects": 2}},
    "huffman-1m.words-100m": {"compress": {"block_size": 65_536},
                              "traffic": {"size": 200_000, "objects": 2}},
}
NEW_METRICS = [f"{m}.{d}" for m in ("host_waits_per_MB", "host_wait_s_per_GB",
                                    "entry_s_per_GB")
               for d in ("compress", "decompress")]
CELL_METRICS = {"huffman-1m.words-100m": [
    "huffman_encode_s_per_GB.compress", "huffman_parse_s_per_GB.decompress",
    "huffman_decode_s_per_GB.decompress", "huffman_pull_s_per_GB.decompress"]}


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

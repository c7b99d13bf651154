"""What the port's tracer (`tpulc_torch/utils/timing.py`) sees in the
benchmark's cells, and what it costs, on the card:

    python3 port_trace.py [--cells a,b] [--seed N] [--staged 3] [--turns 5]

For each cell (`portbench/cells/`, the configuration and an object of
its traffic made from the seed), after a warm round trip:

1. `--staged` round trips under the timer, as the benchmark's staged
   calls run: per direction the share of the root span that no span
   below a block covers (the root's and the block spans' own time), how
   much of each coarse stage its sub-spans cover (without and with the
   timer's syncs), the spans by their own time, the waits a block by
   site, the three totals and the collector's pauses;
2. `--turns` turns of one round trip untraced, one under the timer and
   one under `torch.profiler` (CPU and CUDA activities), in rotating
   order: each mode's median call and its cost over the untraced one.

First a JSON line with what a span and a wait cost with tracing off,
then one a cell on standard output.  Without a card it exits with 3,
unless `--device cpu` (a rehearsal at the size `--size` bytes, whose
times are the CPU's and measure nothing).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
COARSE = ("bz.transform", "bz.tables", "bz.inverse", "bz.walk",
          "bsc.transform", "bsc.inverse")
BLOCK_SPANS = ("bz.block", "bsc.block")


def _union(pairs) -> int:
    total, reach = 0, None
    for a, b in sorted(pairs):
        if reach is not None:
            a = max(a, reach)
        if b > a:
            total += b - a
            reach = b
    return total


def coverage(spans: list) -> dict:
    """One direction's span records -> the uncovered share of its roots,
    each coarse stage's cover by its sub-spans, and own time by name."""
    kids = {}
    for i, s in enumerate(spans):
        kids.setdefault(s["parent"], []).append(i)

    def dur(s):
        return s["end_ns"] - s["start_ns"]

    def own(i, skip=()):
        cov = _union((spans[j]["start_ns"], spans[j]["end_ns"])
                     for j in kids.get(i, []) if spans[j]["name"] not in skip)
        return dur(spans[i]) - cov

    roots = [i for i, s in enumerate(spans) if s["parent"] < 0
             and s["name"] not in ("gc", "timer.sync")]
    root_ns = sum(dur(spans[i]) for i in roots)
    bare = sum(own(i) for i in roots) + sum(
        own(i) for i, s in enumerate(spans) if s["name"] in BLOCK_SPANS)
    stages = {}
    for name in COARSE:
        idx = [i for i, s in enumerate(spans) if s["name"] == name]
        if not idx:
            continue
        total = sum(dur(spans[i]) for i in idx)
        with_sync = total - sum(own(i) for i in idx)
        without = total - sum(own(i, ("timer.sync",)) for i in idx)
        stages[name] = {"seconds": total * 1e-9,
                        "covered_pct": 100.0 * without / total,
                        "covered_with_syncs_pct": 100.0 * with_sync / total}
    by_own = {}
    for i, s in enumerate(spans):
        by_own[s["name"]] = by_own.get(s["name"], 0) + own(i)
    top = sorted(by_own.items(), key=lambda kv: -kv[1])[:12]
    return {"root_s": root_ns * 1e-9,
            "uncovered_pct": 100.0 * bare / max(root_ns, 1),
            "coarse": stages,
            "own_s": [[n, t * 1e-9] for n, t in top]}


def staged(codec, obj, kw, device, timing, n: int) -> dict:
    """n round trips, each direction under its own timer -> a summary by
    direction."""
    out, records = {}, {}
    for d in ("compress", "decompress"):
        out[d] = {"calls": 0, "totals": {}, "sites": {}, "gc_s": 0.0,
                  "gc": 0, "blocks": 0, "seconds": 0.0}
        records[d] = []
    container = None
    for _ in range(n):
        for d in ("compress", "decompress"):
            timer = timing.enable()
            t0 = time.perf_counter()
            if d == "compress":
                container = codec.compress(obj, device=device, **kw)
            else:
                codec.decompress(container, device=device)
            dt = time.perf_counter() - t0
            timing.disable()
            tr = timer.trace()
            o = out[d]
            o["calls"] += 1
            o["seconds"] += dt
            for k, v in tr["totals"].items():
                o["totals"][k] = o["totals"].get(k, 0.0) + v
            for site, v in tr["sites"].items():
                row = o["sites"].setdefault(site, [0, 0.0, 0])
                row[0] += v["waits"]
                row[1] += v["wait_s"]
                row[2] += v["wait_bytes"]
            o["gc"] += timer.counts.get(timing.GC, 0)
            o["gc_s"] += timer.stages.get(timing.GC, 0.0)
            blocks = {s["block"] for s in tr["spans"]
                      if s["block"] is not None}
            o["blocks"] += len(blocks)
            base = len(records[d])
            for s in tr["spans"]:
                if s["parent"] >= 0:
                    s["parent"] += base
                records[d].append(s)
    for d, o in out.items():
        o.update(coverage(records[d]))
        per_block = max(o["blocks"], o["calls"])
        o["waits_a_block"] = sorted(
            ([site, v[0] / per_block, v[1] / per_block]
             for site, v in o["sites"].items()), key=lambda r: -r[1])
        del o["sites"]
    return out


def overhead(codec, obj, kw, device, timing, turns: int, sync) -> dict:
    """Round trips untraced, under the timer and under the profiler, in
    rotating order -> each mode's median call seconds a direction."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device != "cpu" else [])

    @contextlib.contextmanager
    def timer_on():
        timing.enable()
        try:
            yield
        finally:
            timing.disable()

    modes = {"untraced": contextlib.nullcontext,
             "timer": timer_on,
             "profiler": lambda: profile(activities=acts)}
    names = list(modes)
    times = {m: {"compress": [], "decompress": []} for m in names}
    for t in range(turns):
        for m in names[t % 3:] + names[:t % 3]:
            with modes[m]():
                sync()
                t0 = time.perf_counter()
                c = codec.compress(obj, device=device, **kw)
                t1 = time.perf_counter()
                codec.decompress(c, device=device)
                t2 = time.perf_counter()
            times[m]["compress"].append(t1 - t0)
            times[m]["decompress"].append(t2 - t1)
    out = {}
    for m in names:
        out[m] = {d: statistics.median(v) for d, v in times[m].items()}
    for m in ("timer", "profiler"):
        out[m]["cost_pct"] = {
            d: 100.0 * (out[m][d] / out["untraced"][d] - 1.0)
            for d in ("compress", "decompress")}
    return out


def off_cost(timing, n: int = 200_000) -> dict:
    """Nanoseconds a span and a wait add with the timer off and no
    profiler, over the bare loop and the bare call."""
    def per(fn):
        t0 = time.perf_counter_ns()
        fn()
        return (time.perf_counter_ns() - t0) / n

    def spans():
        for _ in range(n):
            with timing.stage("bz.bwt"):
                pass

    def loop():
        for _ in range(n):
            pass

    def waits():
        for _ in range(n):
            timing.wait(int, 5)

    def calls():
        for _ in range(n):
            int(5)

    return {"span_ns": per(spans) - per(loop),
            "wait_ns": per(waits) - per(calls)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells",
                    default="bz.words-25m,bsc-e1.words-25m,bsc-e1.pg-x6")
    ap.add_argument("--seed", type=int, default=2**31 + 4099)
    ap.add_argument("--staged", type=int, default=3)
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=200_000)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.run import cell_spec
    from portbench.traffic import generate
    from tpulc_torch.pipeline.registry import get_codec
    from tpulc_torch.utils import timing

    if a.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3

    def sync():
        if a.device != "cpu":
            torch.cuda.synchronize()

    print(json.dumps({"tracing_off": off_cost(timing)}), flush=True)
    for cell in a.cells.split(","):
        _, config, mix = cell_spec(cell)
        kw = dict(config["compress"])
        if a.device == "cpu":
            mix = {**mix, "size": a.size, "tile": 1}
            kw["block_size"] = min(kw["block_size"], 65536)
        obj = generate.objects(mix, a.seed, ROOT)[0]
        codec = get_codec(config["codec"])
        c = codec.compress(obj, device=a.device, **kw)
        assert codec.decompress(c, device=a.device) == obj.tobytes()
        sync()
        summary = staged(codec, obj, kw, a.device, timing, a.staged)
        cost = overhead(codec, obj, kw, a.device, timing, a.turns, sync)
        print(json.dumps({"cell": cell, "bytes": int(obj.shape[0]),
                          "device": torch.cuda.get_device_name(0)
                          if a.device != "cpu" else "cpu",
                          "staged": summary, "overhead": cost}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

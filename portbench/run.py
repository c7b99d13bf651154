"""Run one cell of the benchmark of tpulc_torch once and print its
result as the last line of standard output.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A cell (`cells/<cell>.json`) names a
configuration (`configs/<name>.json`: the codec and its compress
arguments) and a traffic mix (`traffic/<mix>.json`, made by
`traffic/generate.py` from the seed).  Set-up imports the port, loads
its kernels (the first run in a checkout builds them into
`tpulc_torch/_build/`), makes the objects and runs one warm round trip.
Then one client compresses an object, decompresses the container it got
and goes on to the next object, closed loop, cycling through the
objects until `--seconds` have passed.  With `--trace 1` the run instead
profiles a few round trips and times a few under the program's stage
timer.  Every decompressed output is compared with its object as it
comes, outside the timed call; every distinct container is read back by
the plain decoder of its format (`reference/<codec>.py`, found by the
configuration's codec) once the window has closed.

The metrics printed are the cell's entries of BENCHMARK.json, each read
by `metrics/<name>.py`: `end_to_end` without a trace, `per_layer` with
one.  The run exits with 3 and prints no result when the card is absent
or the cell asks for more cards than there are, and with 4 when jax,
jaxlib, flax or tpulc is loaded in the process.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import hashlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpulc")
PROFILED = 3   # round trips under the profiler (and again without) in a
#                traced run
STAGED = 3     # round trips under the program's stage timer


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(workload: str):
    """-> (cell, configuration, traffic mix) of a cell, by name."""
    cell = load_json(HERE, "cells", f"{workload}.json")
    config = load_json(HERE, "configs", f"{cell['config']}.json")
    mix = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    return cell, config, mix


def cell_metrics(workload: str, trace: int) -> list[dict]:
    """BENCHMARK.json's metrics of this cell for this kind of run."""
    bench = load_json(ROOT, "BENCHMARK.json")
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class RoundTrip:
    """One object's compress and decompress, timed on the host clock:
    their sizes, the container's sha256 and whether the output was the
    object; the bytes themselves are not kept."""

    def __init__(self, index: int):
        self.index = index
        self.container_bytes = self.output_bytes = self.digest = None
        self.output_ok = self.error = None
        self.compress_s = self.decompress_s = None


class Session:
    """The codec under test, its arguments and the run's objects.  Of
    the containers written it keeps the first of each object's distinct
    ones (`containers`, by object and sha256) for the plain decoder."""

    def __init__(self, codec, kw: dict, objs, device: str):
        self.codec, self.kw, self.objs, self.device = codec, kw, objs, device
        self.want = [o.tobytes() for o in objs]
        self.containers = {}

    def round_trip(self, index: int, scope=None) -> RoundTrip:
        """Compress objs[index], then decompress its container; each
        call ends with its bytes on the host.  `scope(direction)`, when
        given, is a context manager entered around each call.  Outside
        the timed calls the container is hashed and the output compared
        with the object, then both are dropped."""
        scope = scope or (lambda _: contextlib.nullcontext())
        rt = RoundTrip(index)
        try:
            with scope("compress"):
                t0 = time.perf_counter()
                container = self.codec.compress(self.objs[index],
                                                device=self.device, **self.kw)
                rt.compress_s = time.perf_counter() - t0
            rt.container_bytes = len(container)
            rt.digest = hashlib.sha256(container).digest()
            self.containers.setdefault((index, rt.digest), container)
            with scope("decompress"):
                t0 = time.perf_counter()
                output = self.codec.decompress(container, device=self.device)
                rt.decompress_s = time.perf_counter() - t0
            rt.output_bytes = len(output)
            rt.output_ok = output == self.want[index]
        except Exception as e:  # a failed call is counted, the loop goes on
            rt.error = f"{type(e).__name__}: {e}"
        return rt


def window_totals(trips, objs) -> dict:
    c = [t for t in trips if t.compress_s is not None]
    d = [t for t in trips if t.decompress_s is not None]
    return {
        "compress": {"bytes": sum(objs[t.index].shape[0] for t in c),
                     "out_bytes": sum(t.container_bytes for t in c),
                     "seconds": sum(t.compress_s for t in c), "calls": len(c)},
        "decompress": {"bytes": sum(t.output_bytes for t in d),
                       "seconds": sum(t.decompress_s for t in d),
                       "calls": len(d)},
    }


def log_calls(trips) -> None:
    """Each direction's call times (quartiles) and its rate over each
    half of the window: how a run's rate came about."""
    import statistics

    for d in ("compress", "decompress"):
        t = [getattr(x, f"{d}_s") for x in trips]
        t = [v for v in t if v is not None]
        if len(t) < 4:
            continue
        q = statistics.quantiles(t, n=4)
        h = len(t) // 2
        log(f"{d} calls {len(t)}: quartiles {q[0]:.4f} {q[1]:.4f} "
            f"{q[2]:.4f} s, min {min(t):.4f} max {max(t):.4f}; mean of "
            f"the halves {sum(t[:h]) / h:.4f} {sum(t[h:]) / (len(t) - h):.4f} s")


def judge(trips, session: Session, codec_name: str) -> dict:
    """Read back every distinct container with the plain decoder of its
    format (`reference/<codec>.py`) and count the decompressed outputs
    that were not their object."""
    decode = importlib.import_module(f"portbench.reference.{codec_name}").decode
    t0 = time.perf_counter()
    read_back = {}
    for (index, digest), c in session.containers.items():
        try:
            read_back[(index, digest)] = \
                decode(c, session.device) == session.want[index]
        except Exception as e:  # a container the format cannot read
            log(f"reference: object {index}: {type(e).__name__}: {e}")
            read_back[(index, digest)] = False
    ref_s = time.perf_counter() - t0
    failed = sum(1 for t in trips if t.error or not t.output_ok
                 or not read_back.get((t.index, t.digest), False))
    return {"containers_wrong": sum(not v for v in read_back.values()),
            "outputs_wrong": sum(1 for t in trips if not t.output_ok),
            "failed": failed, "distinct_containers": len(read_back),
            "reference_s": ref_s}


def traced(session: Session):
    """Profile PROFILED round trips (the hand kernels' calls and the
    program's stages on the timeline), run the same objects again
    untraced, then time STAGED round trips under the program's stage
    timer -> (round trips, the run record's traced parts, device busy
    and window seconds, breakdown)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace

    timing = importlib.import_module("tpulc_torch.utils.timing")
    objs, device = session.objs, session.device
    kc = trace.KernelCalls()

    def scope(direction):
        kc.direction = direction
        return record_function(trace.CALL + direction)

    on_card = device != "cpu"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    trips = []
    with trace.Spans(), kc, profile(activities=acts) as prof:
        for i in range(PROFILED):
            trips.append(session.round_trip(i % len(objs), scope))
    # the same objects without the profiler: its host overhead (several
    # times the call on launch-bound paths) is no part of a call
    plain = [session.round_trip(i % len(objs)) for i in range(PROFILED)]
    trips += plain
    t0 = time.perf_counter()
    rec = {}
    extra = {}
    if on_card:
        p = trace.read_profile(prof, kc.mods)
        bounds = kc.bounds(trace.load_peaks())
        walls = window_totals(plain, objs)
        rec["profile"] = {d: {"traced_wall_s": v["wall_s"],
                              "busy_s": v["busy_s"],
                              "wall_s": walls[d]["seconds"]}
                          for d, v in p["directions"].items()}
        for d, v in rec["profile"].items():
            log(f"profile {d}: device busy {v['busy_s']:.4f} s in "
                f"{v['traced_wall_s']:.4f} s of traced calls; the same "
                f"calls untraced {v['wall_s']:.4f} s")
        rec["roofline"] = trace.roofline(p["directions"], bounds, kc.mods, log)
        extra = {"busy_s": p["busy_s"], "window_s": p["window_s"],
                 "breakdown": {"device_ops": [list(x) for x in p["device_ops"]],
                               "idle_gaps": [list(x) for x in p["idle_gaps"]]}}
    del prof
    kc.calls.clear()
    if on_card:
        # the spies held every profiled call's tensors until the bounds
        # were counted: the program's own peak is read from the round
        # trips that follow, which run every object again
        torch.cuda.reset_peak_memory_stats()
    log(f"trace read in {time.perf_counter() - t0:.3f} s")

    stages = {"compress": {}, "decompress": {}}
    nbytes = {"compress": 0, "decompress": 0}

    @contextlib.contextmanager
    def timed(direction):
        timer = timing.enable()
        try:
            yield
        finally:
            timing.disable()
            for k, v in timer.stages.items():
                stages[direction][k] = stages[direction].get(k, 0.0) + v

    for i in range(STAGED):
        t = session.round_trip((PROFILED + i) % len(objs), timed)
        trips.append(t)
        if t.compress_s is not None:
            nbytes["compress"] += objs[t.index].shape[0]
        if t.decompress_s is not None:
            nbytes["decompress"] += t.output_bytes
    rec["stages"], rec["stage_bytes"] = stages, nbytes
    return trips, rec, extra


def run_cell(workload: str, seed: int, seconds: float, trace: int,
             device: str = "cuda", codec_wrap=None, overrides=None):
    """One run of a cell -> (exit code, result dict or None).

    `device="cpu"` (tests only) skips the look for the card and runs the
    port's plain PyTorch path; `overrides` ({"compress": {...}, "traffic":
    {...}}) resizes the cell for such a run; `codec_wrap(codec)` puts a
    broken codec in the program's place."""
    cell, config, mix = cell_spec(workload)
    overrides = overrides or {}
    kw = {**config["compress"], **overrides.get("compress", {})}
    mix = {**mix, **overrides.get("traffic", {})}
    import torch

    if device != "cpu":
        if not torch.cuda.is_available():
            log("no CUDA device: the benchmark measures the card only")
            return 3, None
        if torch.cuda.device_count() < cell["chips"]:
            log(f"the cell asks for {cell['chips']} cards, "
                f"{torch.cuda.device_count()} present")
            return 3, None
    from portbench.traffic import generate
    from tpulc_torch.pipeline.registry import get_codec

    on_card = device != "cpu"
    marks = [("imports", time.perf_counter())]
    if on_card:
        torch.zeros(1, device=device)
        marks.append(("CUDA context", time.perf_counter()))
    codec = get_codec(config["codec"])
    if codec_wrap is not None:
        codec = codec_wrap(codec)
    objs = generate.objects(mix, seed, ROOT)
    marks.append(("objects", time.perf_counter()))
    session = Session(codec, kw, objs, device)
    warm = session.round_trip(0)
    if warm.error:
        log(f"warm round trip: {warm.error}")
    if on_card:
        torch.cuda.synchronize()
    marks.append(("warm round trip", time.perf_counter()))
    setup_s = marks[-1][1] - _T0
    parts, t = [], _T0
    for name, m in marks:
        parts.append(f"{name} {m - t:.3f}")
        t = m
    log(f"set-up {setup_s:.3f} s ({', '.join(parts)} s); {len(objs)} "
        f"objects of {objs[0].shape[0]} B")

    run = {"setup_s": setup_s}
    extra = {}
    if trace:
        trips, rec, extra = traced(session)
        run.update(rec)
    else:
        trips = []
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            trips.append(session.round_trip(len(trips) % len(objs)))
        log(f"window {time.perf_counter() - w0:.3f} s, "
            f"{len(trips)} round trips")
        log_calls(trips)
        run["window"] = window_totals(trips, objs)
    for t in trips:
        if t.error:
            log(f"round trip on object {t.index}: {t.error}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": cell["chips"], "memory_peak_bytes": peak}
    if trace and on_card:
        dev_info["busy_s"] = extra["busy_s"]
        dev_info["window_s"] = extra["window_s"]
    if on_card:
        torch.cuda.empty_cache()

    verdict = judge(trips, session, config["codec"])
    metrics = {}
    for m in cell_metrics(workload, trace):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    found = sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))
    if found:
        log(f"loaded in this process: {', '.join(found)}")
        return 4, None
    checks = {"containers_wrong": {"value": verdict["containers_wrong"],
                                   "limit": 0},
              "outputs_wrong": {"value": verdict["outputs_wrong"], "limit": 0}}
    result = {"correct": verdict["failed"] == 0 and len(trips) > 0
              and all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(trips), "failed": verdict["failed"],
              "metrics": metrics, "device": dev_info}
    if "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    result["checks"] = checks
    log(f"reference: {verdict['distinct_containers']} distinct containers "
        f"read back in {verdict['reference_s']:.3f} s")
    log(f"check containers_wrong {verdict['containers_wrong']} limit 0 "
        f"(distinct containers the plain decoder does not read back to "
        f"their object)")
    log(f"check outputs_wrong {verdict['outputs_wrong']} limit 0 "
        f"(of {len(trips)} decompressed outputs)")
    return 0, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    code, result = run_cell(a.workload, a.seed, a.seconds, a.trace)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())

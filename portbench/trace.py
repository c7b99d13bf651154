"""What a traced run reads from the program: its stage spans, its hand
kernels' calls, and the device timeline of `torch.profiler`.

- `Spans` puts each `tpulc_torch.utils.timing.stage` of the program on
  the profiler's timeline (a `record_function` named "stage:<name>"),
  without the stage timer's synchronisations.
- `KernelCalls` stands in for every wrapper that `portbench/kernels/`
  names, at every module that holds it, and keeps each call's
  arguments, output and launches, so that the bound of each call can be
  counted once the profiler has closed.
- `read_profile` turns the profiler's events into, per direction, the
  wall time of the calls, the union of device intervals inside them
  (the profiler's own annotations left out), the hand kernels' device
  time, the device ops by time and the idle gaps by the innermost stage
  open on the host; `roofline` sets the kernels' bounds against it.
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import importlib
import importlib.util
import json
import os
import re
import sys

from torch.profiler import record_function

HERE = os.path.dirname(os.path.abspath(__file__))
CALL = "portbench.call:"     # a timed call's range: CALL + direction
STAGE = "stage:"
ANNOTATIONS = (CALL, STAGE)
NAME_CHARS = 160   # a device op's name in the breakdown, cut to this


class Spans:
    """Mirror the program's stages onto the profiler's timeline."""

    def __init__(self):
        self.timing = importlib.import_module("tpulc_torch.utils.timing")
        self.orig = None

    def __enter__(self):
        self.orig = self.timing.stage

        @contextlib.contextmanager
        def stage(name):
            with record_function(STAGE + name):
                yield

        self.timing.stage = stage
        return self

    def __exit__(self, *exc):
        self.timing.stage = self.orig


def kernel_modules() -> dict:
    """portbench/kernels/<wrapper>.py, by wrapper name."""
    mods = {}
    for path in sorted(glob.glob(os.path.join(HERE, "kernels", "*.py"))):
        name = os.path.basename(path)[:-3]
        if name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            f"portbench_kernel_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods[name] = mod
    return mods


class KernelCalls:
    """Record every call of the hand kernels' wrappers while open."""

    def __init__(self):
        self.mods = kernel_modules()
        self.calls = []          # (wrapper, direction, args, kwargs, out, launches)
        self.direction = None
        self._patched = []

    def _spy(self, name, orig):
        def spy(*args, **kwargs):
            before = spy.launches
            out = orig(*args, **kwargs)
            self.calls.append((name, self.direction, args, kwargs, out,
                               spy.launches - before))
            return out

        # the wrapper counts its launches on its module's name, which is
        # the spy while it stands there
        spy.launches = getattr(orig, "launches", 0)
        return spy

    def __enter__(self):
        for name, mod in self.mods.items():
            path, attr = mod.WRAPPER.split(":")
            orig = getattr(importlib.import_module(path), attr)
            spy = self._spy(name, orig)
            for mname, m in list(sys.modules.items()):
                if not mname.startswith("tpulc_torch") or m is None:
                    continue
                for key, val in list(vars(m).items()):
                    if val is orig:
                        setattr(m, key, spy)
                        self._patched.append((m, key, orig, spy))
        return self

    def __exit__(self, *exc):
        for m, key, orig, spy in reversed(self._patched):
            setattr(m, key, orig)
            if hasattr(orig, "launches"):
                orig.launches = spy.launches
        self._patched.clear()

    def bounds(self, peaks: dict) -> dict:
        """(wrapper, direction) -> [calls, launches, bound seconds]."""
        out = {}
        for name, direction, args, kwargs, res, launches in self.calls:
            nbytes, ops = self.mods[name].cost(args, kwargs, res)
            t = max(nbytes / peaks["hbm_bytes_per_s"],
                    ops / peaks["int_ops_per_s"])
            row = out.setdefault((name, direction), [0, 0, 0.0])
            row[0] += 1
            row[1] += launches
            row[2] += t
        self.calls.clear()
        return out


def _union(spans):
    """Sorted, merged intervals."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _clip(merged, a, b):
    return [(max(x, a), min(y, b)) for x, y in merged if y > a and x < b]


def _split(x, y, stages):
    """An idle gap [x, y) cut at the stages' edges -> (the innermost
    stage open over each piece, or "(between stages)", its length)."""
    if y <= x:
        return []
    cuts = sorted({x, y} | {e for s0, s1, _ in stages for e in (s0, s1)
                            if x < e < y})
    out = []
    for u, v in zip(cuts, cuts[1:]):
        mid = (u + v) / 2
        open_ = [(s1 - s0, n) for s0, s1, n in stages if s0 <= mid < s1]
        out.append((min(open_)[1] if open_ else "(between stages)", v - u))
    return out


def read_profile(prof, kernels: dict) -> dict:
    """Per direction: wall_s, busy_s, and the hand kernels' records and
    device seconds by kernel group; over the window: busy_s, window_s,
    device ops by time, idle gaps by the stage open over each part."""
    from torch.autograd import DeviceType

    calls, stages, device = [], [], []
    for ev in prof.events():
        a, b = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            # a record_function range is mirrored onto the device's
            # timeline as an annotation: not an operation
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith(ANNOTATIONS)):
                device.append((a, b, ev.name))
        elif ev.name.startswith(CALL):
            calls.append((a, b, ev.name[len(CALL):]))
        elif ev.name.startswith(STAGE):
            stages.append((a, b, ev.name[len(STAGE):]))
    device.sort()
    starts = [a for a, _, _ in device]
    merged = _union([(a, b) for a, b, _ in device])
    stages.sort()
    patterns = {group_of(m): re.compile(r"\b(" + "|".join(m.KERNELS) + r")\b")
                for m in kernels.values()}
    owner = {}
    for _, _, name in device:
        if name not in owner:
            owner[name] = next((w for w, pat in patterns.items()
                                if pat.search(name)), None)
    out = {}
    gaps = {}
    for a, b, direction in calls:
        d = out.setdefault(direction, {"wall_s": 0.0, "busy_s": 0.0,
                                       "kernels": {}})
        d["wall_s"] += (b - a) * 1e-6
        busy = _clip(merged, a, b)
        d["busy_s"] += sum(y - x for x, y in busy) * 1e-6
        inside = [s for s in stages if s[0] < b and s[1] > a]
        edges = [a] + [v for seg in busy for v in seg] + [b]
        for x, y in zip(edges[0::2], edges[1::2]):
            for name, t in _split(x, y, inside):
                key = f"{direction}:{name}"
                gaps[key] = gaps.get(key, 0.0) + t * 1e-6
        for x, y, name in device[bisect.bisect_left(starts, a):
                                 bisect.bisect_left(starts, b)]:
            w = owner[name]
            if w is not None:
                rec = d["kernels"].setdefault(w, [0, 0.0])
                rec[0] += 1
                rec[1] += (y - x) * 1e-6
    ops = {}
    for a, b, name in device:
        name = name[:NAME_CHARS]
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
    start = min((a for a, _, _ in calls), default=0.0)
    end = max((b for _, b, _ in calls), default=0.0)
    window = _clip(merged, start, end)
    return {
        "directions": out,
        "busy_s": sum(y - x for x, y in window) * 1e-6,
        "window_s": (end - start) * 1e-6,
        "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
    }


def group_of(mod) -> str:
    """Wrappers that launch the same kernels (the running max and min
    scans) share one group: the profiler's records do not tell their
    calls apart."""
    return "+".join(sorted(mod.KERNELS))


def roofline(prof_dirs: dict, bounds: dict, kernels: dict, log) -> dict:
    """Per direction: the hand kernels' bound seconds over their device
    seconds.  A group of wrappers whose kernel launches outnumber the
    profiler's records of them (the profiler lost some) contributes its
    bound scaled to the records it kept, so that lost records never
    raise the share."""
    groups = {}
    for (w, direction), (ncalls, launches, bound_s) in bounds.items():
        g = groups.setdefault((group_of(kernels[w]), direction), [0, 0, 0.0])
        g[0] += ncalls
        g[1] += launches * kernels[w].PER_CALL
        g[2] += bound_s
    out = {}
    for (g, direction), (ncalls, expect, bound_s) in sorted(groups.items()):
        d = prof_dirs.get(direction)
        if d is None or expect == 0:
            continue
        records, dev_s = d["kernels"].get(g, [0, 0.0])
        kept = min(1.0, records / expect)
        log(f"kernel records: {direction} {g}: calls {ncalls} kernels "
            f"expected {expect} recorded {records} device {dev_s:.6f} s "
            f"bound {bound_s:.6f} s")
        row = out.setdefault(direction, {"bound_s": 0.0, "device_s": 0.0})
        row["bound_s"] += bound_s * kept
        row["device_s"] += dev_s
    return out


def load_peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)

"""The port's span-and-counter tracer, grown from a per-stage timer.

Replaces the reference's ad-hoc printf timer pairs (gettimeofday in
CULZSS `main.c:247-274`, clock_gettime phase timers in bzip2
`compress.c:882-1006`, CUHD's TIMER macros `demo.cc:59-168`, bsc's
BSC_CLOCK) with one structured record.

- A span is `with stage(name):`.  While the timer is on (`enable()`),
  each span is kept on the `StageTimer` with its start and end
  (`time.perf_counter_ns`), its parent, its call id (one a span opened
  with no span open: an entry point's call) and its block index
  (`next_block(i)` before a block's span gives it to that span and to
  every span under it).  `StageTimer.stages[name]` sums the seconds of
  every span of that name.
- The names of `STAGES` are the codecs' coarse stages.  The timer
  synchronises the card at their start and their end, so that each
  holds the device work it enqueued and none of its predecessor's;
  those waits are kept as `timer.sync` spans.  Every other span only
  reads the host clock: its seconds are dispatch, host work and its
  own waits.
- `wait(fn, *args)` calls fn, a call in which the host blocks on the
  device (a pull, a pageable upload, a scalar read, an op that
  synchronises inside), and adds its count, seconds and bytes to the
  innermost open span and to its site (file and line of the caller).
  It counts on the CPU too, where nothing waits, so that tests can pin
  the counts of an input.  `upload(array, dev)` is the pageable upload
  of a host array, counted the same way.
- Python's collector pauses are kept as `gc` spans while the timer is
  on.
- While a `torch.profiler` is active, each span is also a
  `record_function("stage:<name>")` range whose `args` carry its ids,
  so that spans sit on the profiler's timeline beside the device ops.

With the timer off and no profiler, `stage` returns a shared null
context after two flag checks, and `wait` and `next_block` check the
timer and return: no record, no clock read, no `record_function`.
Spans are opened from one thread.

The totals the benchmark reads go into `stages` under names no span
takes: `#waits` and `#wait_s` (the waits of every call), and `#entry_s`
(the seconds of each call's root span outside every span of `STAGES`
and the timer's own syncs: uploads, payloads, parsing, checksums and
the container).  A stage's own counters go there too, through
`add_totals` (the LZP encoder's `#lzp_*`, culzss's `#culzss_*`), while
`counting()`.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _profiler

# The codecs' coarse stages: the timer synchronises at their edges.
STAGES = frozenset({
    "bsc.inverse", "bsc.lzp", "bsc.lzp.decode", "bsc.rans",
    "bsc.rans.decode", "bsc.transform", "bsc.unsort", "bsc.unsort.walk",
    "bz.entropy", "bz.inverse", "bz.pull", "bz.tables", "bz.transform",
    "bz.walk", "bzip2.bwt", "bzip2.decode", "bzip2.emit",
    "bzip2.mtf_rle2", "bzip2.rle1", "bzip2.tables", "culzss.candidates",
    "culzss.container", "culzss.doubling", "culzss.grid", "culzss.out",
    "culzss.pack", "culzss.parse", "culzss.payloads", "culzss.pull",
    "culzss.records", "culzss.rounds", "culzss.verify", "huffman.decode",
    "huffman.encode", "huffman.parse", "huffman.pull", "lzss.candidates",
    "lzss.doubling", "lzss.extend", "lzss.pack", "lzss.parse",
    "lzss.pull", "lzss.walks",
})
SYNC = "timer.sync"      # the timer's own synchronisation at a stage edge
GC = "gc"                # a collector pause
PROFILER_PREFIX = "stage:"
WAITS, WAIT_S, ENTRY_S = "#waits", "#wait_s", "#entry_s"
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Span:
    """One span: times in perf_counter nanoseconds, `parent` the index
    of the enclosing span in `StageTimer.spans` (-1 for none), `call`
    and `block` its ids (block None outside a block), and its waits."""

    __slots__ = ("name", "start", "end", "parent", "call", "block",
                 "index", "waits", "wait_ns", "wait_bytes")

    def __init__(self, name, start, parent, call, block, index):
        self.name, self.start, self.end = name, start, start
        self.parent, self.call, self.block = parent, call, block
        self.index = index
        self.waits = self.wait_ns = self.wait_bytes = 0

    def record(self) -> dict:
        return {"name": self.name, "start_ns": self.start,
                "end_ns": self.end, "parent": self.parent,
                "call": self.call, "block": self.block,
                "waits": self.waits, "wait_s": self.wait_ns * 1e-9,
                "wait_bytes": self.wait_bytes}


class StageTimer:
    """The record of the spans and waits while the timer is on."""

    def __init__(self):
        self.stages: dict[str, float] = {}  # name -> seconds, and the totals
        self.counts: dict[str, int] = {}    # name -> spans
        self.spans: list[Span] = []         # in the order they opened
        self.sites: dict[str, list] = {}    # "file:line" -> [waits, ns, bytes]
        self._gc_start = None

    def _add(self, name: str, seconds: float, calls: int = 1) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + calls

    def report(self) -> dict:
        """Seconds and count of each span name (the totals left out)."""
        return {name: {"seconds": round(t, 4), "calls": self.counts[name]}
                for name, t in self.stages.items()
                if not name.startswith("#")}

    def json(self) -> str:
        return json.dumps(self.report())

    def trace(self) -> dict:
        """Every span, the waits by site and the totals."""
        return {"spans": [s.record() for s in self.spans],
                "sites": {k: {"waits": v[0], "wait_s": v[1] * 1e-9,
                              "wait_bytes": v[2]}
                          for k, v in self.sites.items()},
                "totals": {k: v for k, v in self.stages.items()
                           if k.startswith("#")}}

    def _close_root(self, root: Span) -> None:
        """Add a finished call's totals: its waits and its seconds
        outside the coarse stages and the timer's syncs."""
        inside, waits, wait_ns = [], 0, 0
        for s in self.spans[root.index:]:
            if s.call != root.call:
                continue
            waits += s.waits
            wait_ns += s.wait_ns
            if s.name in STAGES or s.name == SYNC:
                inside.append((s.start, s.end))
        covered, reach = 0, root.start
        for a, b in sorted(inside):
            a = max(a, reach)
            if b > a:
                covered += b - a
                reach = b
        self._add(WAITS, waits, 0)
        self._add(WAIT_S, wait_ns * 1e-9, 0)
        self._add(ENTRY_S, (root.end - root.start - covered) * 1e-9, 0)


class _Trace:
    """The process's open spans (shared by the timer and the profiler
    ranges), the last call id and a block index waiting for its span."""

    def __init__(self):
        self.open: list[Span] = []
        self.calls = 0
        self.next_block = None


_TIMER: StageTimer | None = None
_TRACE = _Trace()
_NULL = contextlib.nullcontext()
_SITES: dict = {}   # (file, line) -> the site's key in `StageTimer.sites`
_TOTALS_LOCK = threading.Lock()  # add_totals runs in LZP's worker threads


def enable() -> StageTimer:
    """Install (and return) the process-wide timer."""
    global _TIMER
    disable()
    _TIMER = StageTimer()
    gc.callbacks.append(_gc_phase)
    return _TIMER


def disable() -> None:
    global _TIMER
    _TIMER = None
    if _gc_phase in gc.callbacks:
        gc.callbacks.remove(_gc_phase)


def stage(name: str):
    """A span named `name` (a context manager); a shared null context
    while neither the timer nor a profiler is on.

    Codec hot paths wrap their phases with this: the reference prints
    per-phase timers unconditionally (`compress.c:882-1006`,
    `demo.cc:59-168`); tpulc gates them behind `--timings`."""
    if _TIMER is None and not _profiler._is_profiler_enabled:
        return _NULL
    return _Scope(name)


def next_block(index: int) -> None:
    """Give the next span opened, and the spans under it, this block
    index."""
    if _TIMER is None and not _profiler._is_profiler_enabled:
        return
    _TRACE.next_block = index


def counting() -> bool:
    """Whether a stage's counters are kept: the timer is on."""
    return _TIMER is not None


def add_totals(names, values) -> None:
    """Add each of `values` to the timer's total `names[i]` (a name that
    starts with `#`), from any thread; nothing while the timer is off."""
    timer = _TIMER
    if timer is None:
        return
    with _TOTALS_LOCK:
        for name, v in zip(names, values):
            timer._add(name, v, 0)


def wait(fn, *args, syncs: int = 1, nbytes: int | None = None):
    """fn(*args), a call that blocks the host on the device, counted as
    `syncs` waits (an op that reads back two counts is 2) of `nbytes`
    bytes (default: the first argument's, for a pull, an upload or a
    scalar read) at the caller's line."""
    if _TIMER is None:
        return fn(*args)
    return _wait(sys._getframe(1), fn, args, syncs, nbytes)


def upload(a, dev):
    """A host array (numpy or a CPU tensor) on `dev`: a pageable copy,
    which waits for the device, counted as `wait` counts."""
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    if _TIMER is None:
        return t.to(dev)
    return _wait(sys._getframe(1), torch.Tensor.to, (t, dev), 1, None)


def _wait(frame, fn, args, syncs, nbytes):
    timer = _TIMER
    t0 = time.perf_counter_ns()
    out = fn(*args)
    dt = time.perf_counter_ns() - t0
    if nbytes is None:
        nbytes = _nbytes(args[0]) if args else 0
    key = (frame.f_code.co_filename, frame.f_lineno)
    site = _SITES.get(key)
    if site is None:
        site = _SITES[key] = f"{os.path.relpath(key[0], _PACKAGE)}:{key[1]}"
    row = timer.sites.setdefault(site, [0, 0, 0])
    row[0] += syncs
    row[1] += dt
    row[2] += nbytes
    if _TRACE.open:
        span = _TRACE.open[-1]
        span.waits += syncs
        span.wait_ns += dt
        span.wait_bytes += nbytes
    return out


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return getattr(x, "nbytes", 0)


def _open(name: str) -> Span:
    trace, timer = _TRACE, _TIMER
    if trace.open:
        up = trace.open[-1]
        call, block, parent = up.call, up.block, up.index
    else:
        trace.calls += 1
        call, block, parent = trace.calls, None, -1
    if trace.next_block is not None:
        block, trace.next_block = trace.next_block, None
    index = len(timer.spans) if timer is not None else -1
    span = Span(name, time.perf_counter_ns(), parent, call, block, index)
    if timer is not None:
        timer.spans.append(span)
    trace.open.append(span)
    return span


def _close(span: Span) -> None:
    span.end = time.perf_counter_ns()
    trace = _TRACE
    while trace.open and trace.open.pop() is not span:
        pass
    timer = _TIMER
    if timer is None or span.index < 0 or timer.spans[span.index] is not span:
        return
    timer._add(span.name, (span.end - span.start) * 1e-9)
    if not trace.open:
        timer._close_root(span)


def _leaf(name: str, start: int, end: int) -> None:
    """Keep a finished span with no children (a timer sync, a collector
    pause) under the innermost open span."""
    timer = _TIMER
    up = _TRACE.open[-1] if _TRACE.open else None
    span = Span(name, start, up.index if up else -1, up.call if up else 0,
                up.block if up else None, len(timer.spans))
    span.end = end
    timer.spans.append(span)
    timer._add(name, (end - start) * 1e-9)


def _timer_sync() -> None:
    """Synchronise the card for the timer, kept as a `timer.sync` span."""
    if torch.cuda.is_initialized():
        t0 = time.perf_counter_ns()
        torch.cuda.synchronize()
        _leaf(SYNC, t0, time.perf_counter_ns())


class _Scope:
    __slots__ = ("name", "span", "synced", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        self.synced = _TIMER is not None and self.name in STAGES
        if self.synced:
            _timer_sync()
        self.span = _open(self.name)
        if _profiler._is_profiler_enabled:
            s = self.span
            up = _TRACE.open[-2].name if len(_TRACE.open) > 1 else ""
            self.rf = _profiler.record_function(
                PROFILER_PREFIX + self.name,
                f"call={s.call} block={s.block} parent={up}")
            self.rf.__enter__()

    def __exit__(self, *exc):
        if self.synced and _TIMER is not None:
            _timer_sync()
        _close(self.span)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _gc_phase(phase: str, info: dict) -> None:
    """gc.callbacks hook: a collector pause becomes a `gc` span under
    the innermost open span."""
    timer = _TIMER
    if timer is None:
        return
    now = time.perf_counter_ns()
    if phase == "start":
        timer._gc_start = now
        return
    if timer._gc_start is None:
        return
    start, timer._gc_start = timer._gc_start, None
    _leaf(GC, start, now)

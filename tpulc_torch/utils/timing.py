"""Structured per-stage timing.

Replaces the reference's ad-hoc printf timer pairs (gettimeofday in
CULZSS `main.c:247-274`, clock_gettime phase timers in bzip2
`compress.c:882-1006`, CUHD's TIMER macros `demo.cc:59-168`, bsc's
BSC_CLOCK) with one structured report object.  Stages time the host
clock; while the timer is on, a stage synchronises the card at its
start and its end (when CUDA is in use), so that it holds the device
work it enqueued and none of its predecessor's.

Copied from `tpulc/utils/timing.py` (the port may not import tpulc,
whose package import pulls in jax).
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class StageTimer:
    """Accumulates named stage wall times; reports a dict or JSON."""

    stages: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, total_bytes: int | None = None) -> dict:
        out = {
            name: {
                "seconds": round(t, 4),
                "calls": self.counts[name],
                **(
                    {"MBps": round(total_bytes / 1e6 / t, 2)}
                    if total_bytes and t > 0 else {}
                ),
            }
            for name, t in self.stages.items()
        }
        return out

    def json(self, total_bytes: int | None = None) -> str:
        return json.dumps(self.report(total_bytes))


# ---------------------------------------------------------------------------
# Opt-in global timer: codecs report stages when the CLI (or a caller)
# enables it; zero overhead otherwise.

_GLOBAL: StageTimer | None = None


def enable() -> StageTimer:
    """Install (and return) the process-wide stage timer."""
    global _GLOBAL
    _GLOBAL = StageTimer()
    return _GLOBAL


def disable() -> None:
    global _GLOBAL
    _GLOBAL = None


def get() -> StageTimer | None:
    return _GLOBAL


@contextmanager
def stage(name: str):
    """Record a stage on the global timer; no-op when disabled.

    Codec hot paths wrap their phases with this — the reference prints
    per-phase timers unconditionally (`compress.c:882-1006`,
    `demo.cc:59-168`); tpulc gates them behind `--timings`."""
    if _GLOBAL is None:
        yield
        return
    _sync()
    with _GLOBAL.stage(name):
        yield
        _sync()


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()

"""Seconds the host stood blocked in the program's device reads ("#wait_s"
of its tracer) per GB compressed, in the staged calls."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "compress", ("#wait_s",))

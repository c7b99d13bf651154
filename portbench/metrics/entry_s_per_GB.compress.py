"""Seconds of the program's entry-point calls outside every coarse stage
and the stage timer's own syncs ("#entry_s" of its tracer: uploads,
payloads, parsing, adler32, the container) per GB compressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "compress", ("#entry_s",))

"""Seconds of the host LZP encode (stage bsc.lzp) per GB compressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "compress", ("bsc.lzp",))

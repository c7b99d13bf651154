"""Seconds of the entropy coders' encode (stages bz.tables and bz.entropy,
bsc.rans) per GB compressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "compress", ("bz.tables", "bz.entropy", "bsc.rans"))

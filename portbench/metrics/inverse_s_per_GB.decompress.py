"""Seconds of the inverse transforms (stages bz.inverse and bsc.inverse:
zero runs, MTF, inverse BWT) per GB decompressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "decompress", ("bz.inverse", "bsc.inverse"))

"""Seconds of the forward transforms (the program's stages bz.transform and
bsc.transform: BWT, MTF, RUNA/RUNB) per GB compressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "compress", ("bz.transform", "bsc.transform"))

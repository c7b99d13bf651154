"""Seconds of the entropy coders' decode (stages bz.walk and
bsc.rans.decode) per GB decompressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "decompress", ("bz.walk", "bsc.rans.decode"))

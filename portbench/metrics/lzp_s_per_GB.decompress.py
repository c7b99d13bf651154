"""Seconds of the host LZP decode (stage bsc.lzp.decode) per GB
decompressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "decompress", ("bsc.lzp.decode",))

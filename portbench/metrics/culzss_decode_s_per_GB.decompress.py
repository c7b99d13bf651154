"""Seconds of the culzss decode on the device (stages culzss.records and
culzss.rounds: the flag groups as an orbit, the token grid, the copy
sources resolved by pointer doubling) per GB decompressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "decompress",
                          ("culzss.records", "culzss.rounds"))

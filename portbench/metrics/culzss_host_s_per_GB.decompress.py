"""Seconds of the culzss decompress's host stages and transfers (stages
culzss.payloads, culzss.out and culzss.verify: the payloads parsed and
uploaded, the checks of the packets' lengths and the pull, the data
adler32) per GB decompressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "decompress", ("culzss.payloads",
                                              "culzss.out", "culzss.verify"))

"""Seconds of the culzss compress's host stages and transfers (stages
culzss.grid, culzss.pull and culzss.container: the packet grid and its
upload, the bodies' compaction and pull, the payloads and the
container) per GB compressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "compress", ("culzss.grid", "culzss.pull",
                                            "culzss.container"))

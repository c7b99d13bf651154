"""Seconds of the culzss encode's match finding (stages
culzss.candidates and culzss.doubling: each packet's equality rows
against the 128 earlier bytes, the int8 doubling passes that turn them
into runs, the longest run's pick) per GB compressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "compress",
                          ("culzss.candidates", "culzss.doubling"))

"""Seconds of the culzss encode's greedy parse and packing (stages
culzss.parse and culzss.pack: the token starts found as an orbit by
pointer doubling, tokens and flag bytes scattered to prefix-summed
offsets) per GB compressed."""

from portbench.metrics import stage_s_per_gb


def read(run):
    return stage_s_per_gb(run, "compress", ("culzss.parse", "culzss.pack"))

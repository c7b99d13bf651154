"""Input bytes of every compress call completed in the window over the
summed host-clock seconds of those calls."""

from portbench.metrics import rate_mb_s


def read(run):
    return rate_mb_s(run, "compress")

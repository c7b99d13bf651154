"""Seconds from the process's start to the first timed call: imports,
the kernels' build (a checkout's first run) and load, the objects made
from the seed, one warm round trip."""


def read(run):
    return run.get("setup_s")

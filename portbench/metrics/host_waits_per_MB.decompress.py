"""Blocking reads of the device per MB of the decompressed bytes: the
count the program's tracer keeps under "#waits" (every pull, pageable
upload, scalar read and op that synchronises inside, over the staged
calls)."""

from portbench.metrics import stage_s_per_gb


def read(run):
    v = stage_s_per_gb(run, "decompress", ("#waits",))
    return None if v is None else v / 1e3

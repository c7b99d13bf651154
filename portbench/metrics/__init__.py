"""One reader a metric: `<metric name>.py` holds `read(run) -> float |
None`, where `run` is the record that `portbench.run` keeps of one run:

- "setup_s": seconds from the process's start to the first timed call;
- "window" (untraced runs): per direction ("compress", "decompress") the
  bytes in and out, the seconds and the count of the calls that
  completed in the window;
- "profile" (traced runs on the card): per direction the seconds of the
  union of device intervals inside the profiled calls ("busy_s"), their
  wall seconds ("traced_wall_s") and the wall seconds of the same
  objects' calls run again without the profiler ("wall_s");
- "roofline" (traced runs on the card): per direction the hand kernels'
  bound seconds and their recorded device seconds;
- "stages" and "stage_bytes" (traced runs): per direction the seconds of
  each of the program's stages under its stage timer, and the bytes of
  those calls.

A reader that finds nothing to read returns None, and the run leaves
the metric out.
"""

from __future__ import annotations


def stage_s_per_gb(run: dict, direction: str, names: tuple) -> float | None:
    """Seconds of the named stages per GB of the direction's bytes."""
    stages = run.get("stages", {}).get(direction, {})
    found = [stages[n] for n in names if n in stages]
    nbytes = run.get("stage_bytes", {}).get(direction, 0)
    if not found or nbytes <= 0:
        return None
    return sum(found) / (nbytes / 1e9)


def rate_mb_s(run: dict, direction: str) -> float | None:
    w = run.get("window", {}).get(direction)
    if not w or w["seconds"] <= 0:
        return None
    return w["bytes"] / w["seconds"] / 1e6

"""Share of a compress call's time in which no operation runs on the
device, in percent: 1 - the union of device intervals in the traced
calls / the same objects' calls timed without the profiler (whose host
overhead is no part of a call)."""


def read(run):
    p = run.get("profile", {}).get("compress")
    if not p or p["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])

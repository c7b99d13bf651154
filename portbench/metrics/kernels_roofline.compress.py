"""The hand kernels' share of their roofline in the traced compress calls:
the sum of each launch's bound (portbench/kernels/) over the sum of
the profiler's device time of their kernels, in percent."""


def read(run):
    r = run.get("roofline", {}).get("compress")
    if not r or r["device_s"] <= 0:
        return None
    return 100.0 * r["bound_s"] / r["device_s"]

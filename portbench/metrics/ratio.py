"""Input bytes of the window's compress calls over their container
bytes."""


def read(run):
    w = run.get("window", {}).get("compress")
    if not w or w["out_bytes"] <= 0:
        return None
    return w["bytes"] / w["out_bytes"]

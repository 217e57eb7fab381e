"""The share of the traced train window in which no operation ran on the
card: 100 minus the busy share (the union of the device's kernel, copy and
set intervals over the window)."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "train" or t is None:
        return None
    return 100 * (1 - t["busy_s"] / t["window_s"])

"""The share of the time the server spends on requests in which no
operation ran on the card: 100 minus the device's busy share inside the
traced window's ``chipbench.request`` spans (each from a batch's start to
its first tokens on the host).  The open loop's waits for arrivals are
left out: a faster prefill leaves the card idle for longer between
arrivals, which says nothing of how well it keeps the card busy."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "prefill" or t is None or not t.get("serving_s"):
        return None
    return 100 * (1 - t["serving_busy_s"] / t["serving_s"])

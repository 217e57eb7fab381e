"""Device milliseconds a train step of the port's mamba mixers: the
operations launched while the port's ``repro_torch.mamba.mix`` span was
open on the launching thread (forward, recompute and backward; the scan
among them), read from the traced window (``trace_hybrid``), over the
window's steps."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "train" or t is None or not t.get("mamba_mix_s") or not r["steps"]:
        return None
    return 1e3 * t["mamba_mix_s"] / r["steps"]

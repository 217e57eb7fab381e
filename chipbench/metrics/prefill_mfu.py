"""Prefill's share of the card's bf16 peak while it serves: the FLOPs of
the window's prompts (``counts.prefill_flops``) over the time the server
spent on them (each request from the start of its prefill to its first
tokens on the host; the open loop's waits for arrivals left out), over
989 TFLOP/s."""

from chipbench import counts


def read(r):
    if r.get("kind") != "prefill" or not r["batches"]:
        return None
    return 100 * r["model_flops"] / sum(r["service_s"]) / counts.PEAK_FLOPS

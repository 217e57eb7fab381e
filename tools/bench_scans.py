#!/usr/bin/env python3
"""Time the port's two scans, forward and backward, at their main shapes on one CUDA card.

    python3 tools/bench_scans.py [--src DIR]

Imports ``ssm_scan`` and ``rglru_scan`` from the tree at DIR (default: this
checkout's ``src/``), so the kernels build from that tree's sources, and
times, with ``chip_smoke``'s inputs and timer, twice each: the forward
kernels at their main shapes in bf16 (falcon-mamba-7b's prefill,
recurrentgemma-9b's), and the backward kernels at the training shapes
(``SSM_TRAIN``, ``RGLRU_TRAIN``, bf16) from one forward's saved carries,
with each backward's device time by kernel (the main kernel and its
fixed-order sums) from one more call under ``torch.profiler``.  To compare
two commits on one card, unpack the other under ``build/`` (``git
archive``) and run parent, change, change, parent in one call.  Prints
the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def backward_calls(torch, cs, ssm_scan, rglru_scan) -> dict:
    """{kernel: (call, iterations)}: each scan backward at its training
    shape in bf16 (``SSM_TRAIN``, ``RGLRU_TRAIN``) from one forward's
    carries, with ``chip_smoke``'s inputs, as its phase 6 times them."""
    ins = ssm_scan._prepare(*cs.ssm_inputs(torch, cs.SSM_TRAIN, torch.bfloat16,
                                           seed=93))
    _, _, carries = ssm_scan._forward(*ins, save=True)
    dy = cs.randn(torch, torch.Generator(device="cuda").manual_seed(92),
                  ins[0].shape, torch.bfloat16)
    rins = rglru_scan._prepare(*cs.rglru_inputs(torch, cs.RGLRU_TRAIN,
                                                torch.bfloat16, seed=91))
    _, _, rcarries = rglru_scan._forward(*rins, 8.0, save=True)
    dh = cs.randn(torch, torch.Generator(device="cuda").manual_seed(90),
                  rins[0].shape, torch.bfloat16)
    return {"ssm_scan_bwd": (
                lambda: ssm_scan.ssm_scan_bwd_cuda(dy, None, *ins[:6], carries), 10),
            "rglru_scan_bwd": (
                lambda: rglru_scan.rglru_scan_bwd_cuda(dh, None, *rins[:4], rcarries),
                20)}


def device_ms_by_kernel(torch, call) -> dict:
    """Device ms of one ``call`` by kernel name, from ``torch.profiler``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_scans: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import rglru_scan, ssm_scan

    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    out = {"src": args.src}
    for name, fn, inputs in (
            ("ssm_scan", ssm_scan.ssm_scan_cuda,
             cs.ssm_inputs(torch, cs.SSM_MAIN, torch.bfloat16, seed=98)),
            ("rglru_scan", rglru_scan.rglru_scan_cuda,
             cs.rglru_inputs(torch, cs.RGLRU_MAIN, torch.bfloat16, seed=97))):
        out[name] = [cs.time_ms(torch, lambda: fn(*inputs), iters=30) for _ in range(2)]
    for name, (call, iters) in backward_calls(torch, cs, ssm_scan, rglru_scan).items():
        out[name] = {"ms": [cs.time_ms(torch, call, iters=iters) for _ in range(2)],
                     "device_ms_by_kernel": device_ms_by_kernel(torch, call)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

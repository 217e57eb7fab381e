#!/usr/bin/env python3
"""Time the port's two scan kernels at their main shapes on one CUDA card.

    python3 tools/bench_scans.py [--src DIR]

Imports ``ssm_scan_cuda`` and ``rglru_scan_cuda`` from the tree at DIR
(default: this checkout's ``src/``), so each builds from that tree's
sources, and times each at its main shape in bf16 (falcon-mamba-7b's
prefill, recurrentgemma-9b's) with ``chip_smoke``'s inputs and timer,
twice.  To compare two commits on one card, unpack the other under
``build/`` (``git archive``) and run parent, change, change, parent in
one session.  Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

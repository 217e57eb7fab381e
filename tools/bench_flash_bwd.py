#!/usr/bin/env python3
"""Time the port's flash-attention backward at its training shapes on one CUDA card.

    python3 tools/bench_flash_bwd.py [--src DIR]

Imports ``flash_attention`` from the tree at DIR (default: this checkout's
``src/``), so the kernels build from that tree's sources, and times the
bf16 backward alone, from one forward's saved tensors, with
``chip_smoke``'s inputs and timer: at starcoder2-3b's training shape (head
dim 128) and at recurrentgemma-9b's local training shape (head dim 256,
window 2048), twice each, and reads each kernel's device time in one more
call from ``torch.profiler``.  To compare two commits on one card, unpack
the other under ``build/`` (``git archive``) and run parent, change,
change, parent on one card, one after another.  Prints the card's name and power limit,
then one JSON line with each shape's path, times in ms and device ms by
kernel.
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
        print("bench_flash_bwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa

    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    out = {"src": args.src}
    for name, shape, iters in (("starcoder2_train", cs.TRAIN_SHAPE, 20),
                               ("recurrentgemma_local_train", cs.LOCAL_TRAIN_SHAPE, 5)):
        B, T, S, H, K, D, causal, window = shape
        q, k, v = cs.attn_inputs(torch, shape, torch.bfloat16, seed=96)
        dout = cs.randn(torch, torch.Generator(device="cuda").manual_seed(95),
                        q.shape, torch.bfloat16)
        o, lse, o_lo = fa._forward(q, k, v, causal, window, D ** -0.5, with_lse=True)
        path = fa.PATHS[fa.bwd_path(q.dtype, D, fa._aligned(q, k, v, dout))]

        def call():
            return fa.flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal=causal,
                                               window=window, o_lo=o_lo)

        ms = [cs.time_ms(torch, call, iters=iters) for _ in range(2)]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        by_kernel = {e.key[:60]: e.device_time_total / 1e3
                     for e in prof.key_averages() if e.device_time_total > 0}
        out[name] = {"shape": list(shape), "path": path, "ms": ms,
                     "device_ms_by_kernel": by_kernel}
        del q, k, v, dout, o, lse, o_lo
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Hold every head-dim 256 flash backward of a training run against f32 autograd of plain.

    python3 tools/flash_bwd_activations.py [--src DIR] --arch paligemma-3b --batch 4 \\
        --seq 512 --steps 6 --microbatches 1

Runs ``repro_torch.launch.train`` (the other arguments are its own) from the
tree at DIR (default: this checkout's ``src/``) on one CUDA card, with
``flash_attention_bwd_cuda`` wrapped: each call at head dim 256 is also
computed by autograd of the plain attention in f32 on the same q, k, v and
dO.  Prints the number of calls checked and, over all of them, the largest
|err| / (2e-2 + 2e-2 |want|) of dq, dk and dv (1 is the bf16 tolerance
``chip_smoke.py`` holds the kernel to), the largest |err| and the largest
|want|.  So the kernel is held on the model's own activations, not only on
random inputs.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args, train_args = ap.parse_known_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_activations: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import train

    kernel = fa.flash_attention_bwd_cuda
    rows = []        # per call: (max |err|, max ratio, max |want|) of dq, dk, dv

    def checked(q, k, v, o, lse, dout, *, causal=True, window=0, scale=None, o_lo=None):
        got = kernel(q, k, v, o, lse, dout, causal=causal, window=window, scale=scale,
                     o_lo=o_lo)
        if q.shape[-1] == 256:
            with torch.enable_grad():
                leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
                want = torch.autograd.grad(
                    ref.attention_ref(*leaves, causal=causal, window=window, scale=scale),
                    leaves, dout.float())
            row = []
            for g, w in zip(got, want):
                err = (g.float() - w).abs()
                row.append((err.max().item(), (err / (TOL + TOL * w.abs())).max().item(),
                            w.abs().max().item()))
            rows.append(row)
        return got

    fa.flash_attention_bwd_cuda = checked
    train.main(train_args)
    if not rows:
        print("flash_bwd_activations: no head-dim 256 backward ran", file=sys.stderr)
        return 1
    worst = [max(r[i][1] for r in rows) for i in range(3)]
    print(f"checked {len(rows)} backward calls; worst |err| / ({TOL} + {TOL} |want|) for dq, "
          f"dk, dv: {worst}; max |err| {[max(r[i][0] for r in rows) for i in range(3)]}; "
          f"max |want| {[max(r[i][2] for r in rows) for i in range(3)]}", flush=True)
    return 0 if max(worst) <= 1 else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s mesh phase alone on one CUDA card.

    python3 tools/mesh_phase.py

Builds every kernel (one nvcc per source, as ``chip_smoke`` does), then
runs ``chip_smoke.run_mesh_phase``: 4 ranks on the one card over gloo, a
(data=2, model=2) mesh, granite-moe-1b-a400m's sharded step against the
unsharded one in f32 and its 24 layers in bf16, recurrentgemma-9b's sharded
forward and sharded serving, phi3.5-moe-42b-a6.6b's sharded ``sort_scatter``
step and serving at full width (1 layer, f32) against the unsharded ones,
granite's sharded checkpoint, ``compressed_psum``, with the same checks and
printed lines, and beside it ``chip_smoke``'s dry-run cells on the host (each
held against the reference's committed record of the cell).  Any failed check raises.  Prints the card's name and
power limit first, and last the phase's wall time and its launch counts
summed over the ranks.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.load_all([getattr(m, src) for m, src, _ in cs.kernel_table().values()])
    launches: dict = {}
    t0 = time.perf_counter()
    dryruns = cs.start_dryruns()
    cs.run_mesh_phase(torch, launches, smi)
    cs.finish_dryruns(dryruns)
    print(f"mesh phase {time.perf_counter() - t0:.1f} s; launches summed over "
          f"the ranks {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Readings that the limits of a hybrid training cell's check are set from,
as ``calibrate.py`` takes them for the other training cells.

    python3 chipbench/calibrate_hybrid.py --workload jamba2-3b-train-8k \\
        --seeds 11,12,13 --control-seeds 11 --fault-seeds 11 --out build/calib.json

For each seed, in one process: the program's first steps against the
reference; on the control seeds the control's (the reference one
precision below the configuration's, float8 products); on the fault seeds
the program with half of each batch left out.  A step that returns its
state unchanged reads 1 and needs no run.  Prints one JSON line per seed
and writes them all to ``--out``.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from chipbench import harness
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)
    K = harness.kind(cell)
    dev = torch.device("cuda")
    steps = cell.traffic["check_steps"]
    rows = []
    for seed in args.seeds:
        s = K.Session(cell, seed, dev)
        t = time.perf_counter()
        first = s.first_steps(steps)
        torch.cuda.synchronize()
        row = {"seed": seed, "program_s": time.perf_counter() - t,
               "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        s.release()
        del s
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        ref = K.reference_run(cell, seed, dev)
        row.update(reference_s=time.perf_counter() - t, program=K.numbers(first, ref),
                   losses=first["loss"], ref_losses=ref["loss"],
                   reference_peak_bytes=torch.cuda.max_memory_allocated(dev))
        if seed in args.control_seeds:
            ctl = K.reference_run(cell, seed, dev, fp8=True)
            row["control"], row["control_losses"] = K.numbers(ctl, ref), ctl["loss"]
        if seed in args.fault_seeds:
            s = K.Session(cell, seed, dev, fault="half_batch")
            bad = s.first_steps(steps)
            s.release()
            del s
            row["half_batch"], row["half_batch_losses"] = K.numbers(bad, ref), bad["loss"]
        rows.append(row)
        print(json.dumps(row), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

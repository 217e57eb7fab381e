#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from.

    python3 chipbench/calibrate.py --workload starcoder2-train-2k \\
        --seeds 11,12,13 --control-seeds 11,12,13 --fault-seeds 11,12,13 \\
        --out build/calib.json

For each seed, in one process: the program's numbers (as a run compares
them: a training cell's first steps, a prefill cell's sampled requests of
a short window at the cell's own load) against the reference; on the
control seeds the control's, the reference put in the program's place and
computed one precision below the configuration's (float8 products); on
the fault seeds each fault of the cell's kind planted in the program
(training: half of each batch left out; serving: the first token altered
where it is produced).  A prefill window lasts at least until the last
batch the check may sample is due.  A step that returns its state unchanged reads 1 by
the training numbers' measure and needs no run.  Prints one JSON line per
seed and writes them all to ``--out``.  The benchmark's own runs never run
this.

``--rates r1,r2,...`` instead sweeps a prefill cell's arrival rate (request
batches a second), one window of ``--seconds`` each on the first seed:
the batches completed a second, the tail of the time to first token and
how late the last request started, to find the most the card sustains.
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


def train_seed(cell, seed, control, fault, dev) -> dict:
    from chipbench.kinds import train as K
    s = K.Session(cell, seed, dev)
    first = s.first_steps(cell.traffic["check_steps"])
    s.release()
    del s
    t = time.perf_counter()
    ref = K.reference_run(cell, seed, dev)
    out = {"seed": seed, "reference_s": time.perf_counter() - t,
           "program": K.numbers(first, ref), "losses": first["loss"],
           "ref_losses": ref["loss"]}
    if control:
        ctl = K.reference_run(cell, seed, dev, fp8=True)
        out["control"], out["control_losses"] = K.numbers(ctl, ref), ctl["loss"]
    if fault:
        s = K.Session(cell, seed, dev, fault="half_batch")
        bad = s.first_steps(cell.traffic["check_steps"])
        s.release()
        del s
        out["half_batch"], out["half_batch_losses"] = K.numbers(bad, ref), bad["loss"]
    return out


def prefill_seed(cell, seed, control, fault, dev, seconds) -> dict:
    from chipbench.kinds import prefill as K
    s = K.Session(cell, seed, dev)
    s.warm()
    _, due = K.schedule(cell.traffic, cell.traffic["check_within"])
    rd = s.window(max(seconds, due[-1] + 1e-3), False)
    kept = s.kept
    s.release()
    del s
    t = time.perf_counter()
    out = {"seed": seed, "batches": rd["batches"],
           "program": K.compare(cell, seed, kept, dev),
           "reference_s": time.perf_counter() - t}
    if control:
        out["control"] = K.compare(cell, seed, kept, dev, fp8=True)
    if fault:
        bad = {i: ((tok + 1) % cell.config["model"]["vocab"], c)
               for i, (tok, c) in kept.items()}
        out["token"] = K.compare(cell, seed, bad, dev)
    return out


def sweep(cell, seed, rates, dev, seconds) -> list:
    import numpy as np
    from chipbench.kinds import prefill as K
    s = K.Session(cell, seed, dev)
    s.warm()
    rows = []
    for rate in rates:
        s.kept.clear()
        rd = s.window(seconds, False, rate=rate)
        rows.append({"rate": rate, "completed_per_s": rd["batches"] / rd["window_s"],
                     "ttft_ms_p95": float(np.percentile(rd["ttft_s"], 95)) * 1e3,
                     "last_start_late_ms": rd["late_s"][-1] * 1e3,
                     "service_ms_mean": float(np.mean(rd["service_s"])) * 1e3})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--rates", type=lambda v: [float(x) for x in v.split(",")], default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from chipbench import harness
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)
    dev = torch.device("cuda")
    if args.rates:
        rows = sweep(cell, args.seeds[0], args.rates, dev, args.seconds)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
        return 0
    rows = []
    for seed in args.seeds:
        control, fault = seed in args.control_seeds, seed in args.fault_seeds
        if cell.traffic["kind"] == "train":
            row = train_seed(cell, seed, control, fault, dev)
        else:
            row = prefill_seed(cell, seed, control, fault, dev, args.seconds)
        row["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        rows.append(row)
        print(json.dumps(row), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

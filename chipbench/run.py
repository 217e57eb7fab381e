#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 chipbench/run.py --workload starcoder2-train-2k --seed 12345 \\
        --seconds 30 --trace 0

Loads the cell's configuration and traffic by name (see
:mod:`chipbench.harness`), makes the weights and inputs from ``--seed``,
warms up, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON line last: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics and the
device's busy time (``--trace 1``).  The numbers compared are printed last
on standard error, each beside its limit, and under ``checks`` in the
line.  Without the CUDA cards the cell asks for it exits 2 and prints no
result; so it does if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chipbench import harness
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)
    out = harness.kind(cell).run(cell, args.seed, args.seconds, bool(args.trace),
                                 start=START)
    found = harness.forbidden_modules()
    if found:
        print(f"chipbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    line = harness.result(cell, out, bool(args.trace))
    sys.stdout.flush()
    print("\n".join(out.notes + [harness.check_lines(out.checks)]),
          file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

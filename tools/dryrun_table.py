#!/usr/bin/env python3
"""Print the dry run's artifacts as a markdown table, one row per
(arch, shape), the single-pod and multi-pod meshes side by side.

    python3 tools/dryrun_table.py [--dir artifacts/dryrun_torch]

Reads what ``python -m repro_torch.launch.dryrun --all --mesh both`` wrote.
Per device: state, batch (train) and cache (serving) bytes, the bytes
autograd saves for the backward (train), FLOPs (dot products plus the
kernels'), op bytes (unfused), collective wire bytes (ring model), and
whether state + batch + cache + saved fit one 80 GB card.  A cell that is
not ``ok`` shows its status (and an error's first line).  The last line
is each mesh's count of cells by status.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("single", "multi")


def _fmt(rec, key, scale, digits=2):
    v = rec.get(key)
    return "–" if v is None else f"{v / scale:.{digits}f}"


def _cell(rec):
    if rec is None:
        return ["missing"] * 8
    if rec["status"] != "ok":
        first = (rec.get("error") or rec.get("reason") or "").splitlines()[:1]
        return [rec["status"] + (f": {first[0][:60]}" if first else "")] + [""] * 7
    return [_fmt(rec, "state_bytes_per_device", 2 ** 30),
            _fmt(rec, "batch_bytes_per_device", 2 ** 20),
            _fmt(rec, "cache_bytes_per_device", 2 ** 30),
            _fmt(rec, "saved_bytes_per_device", 2 ** 30),
            f"{rec['flops_per_device']:.3e}",
            f"{rec['op_bytes_per_device']:.3e}",
            f"{rec['collectives']['wire_bytes_per_device']:.3e}",
            "yes" if rec["fits_80gb"] else "no"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default=str(ROOT / "artifacts" / "dryrun_torch"))
    args = ap.parse_args(argv)
    recs = {}
    for path in sorted(Path(args.dir).glob("*.json")):
        r = json.loads(path.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    cols = ["state GiB", "batch MiB", "cache GiB", "saved GiB", "FLOPs",
            "op bytes", "wire bytes", "fits 80 GB"]
    print("| arch | shape | " + " | ".join(f"{c} (s / m)" for c in cols) + " |")
    print("| --- | --- |" + " --- |" * len(cols))
    tally = {m: collections.Counter() for m in MESHES}
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.dryrun import all_cells
    for arch, shape in all_cells():
        got = {m: recs.get((arch, shape, m)) for m in MESHES}
        for m, r in got.items():
            tally[m][r["status"] if r else "missing"] += 1
        if all(r is not None and r["status"] == "skipped" for r in got.values()):
            continue
        cells = [_cell(got[m]) for m in MESHES]
        print(f"| {arch} | {shape} | " + " | ".join(
            f"{a} / {b}" for a, b in zip(*cells)) + " |")
    print("; ".join(f"{m}: " + ", ".join(f"{n} {s}" for s, n in sorted(t.items()))
                    for m, t in tally.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

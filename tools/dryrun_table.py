#!/usr/bin/env python3
"""Print the dry run's artifacts as markdown tables, one row per
(arch, shape), the single-pod and multi-pod meshes side by side.

    python3 tools/dryrun_table.py [--dir artifacts/dryrun_torch]
                                  [--ref artifacts/dryrun_reference]

Reads what ``python -m repro_torch.launch.dryrun --all --mesh both`` wrote
and, for the second table, what ``tools/dryrun_reference.py --all --mesh
both`` wrote.

The first table, per device: state, batch (train) and cache (serving)
bytes, the bytes autograd saves for the backward (train), FLOPs (dot
products plus the kernels'), op bytes (unfused), collective wire bytes
(ring model), and whether state + batch + cache + saved fit one 80 GB card.

The second table holds the port against the reference's own dry run, per
device, one row per (arch, shape) with both meshes: the port's dense FLOPs
(attention at its dense count, as the reference's chunked attention
computes it) and the reference's HLO dot FLOPs, the port's and the
reference's collective wire bytes, and the two ratios port / reference.  A row names each limit it misses (s / m for the
mesh): a FLOP ratio above 1.15, a train cell's wire ratio above 2, per-device
state, batch or cache bytes that differ, or a status other than the
reference's.

A cell that is not ``ok`` shows its status (and an error's first line).
Under each table, each mesh's count of cells by status, and of the limits
missed.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("single", "multi")
FLOP_LIMIT, WIRE_LIMIT = 1.15, 2.0
BYTES = ("state_bytes_per_device", "batch_bytes_per_device", "cache_bytes_per_device")


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


def compare(port, ref):
    """(cells of the comparison row, the limits missed) of one mesh's port
    and reference records."""
    if port is None or ref is None or "ok" not in (port["status"], ref["status"]):
        st = [r["status"] if r else "missing" for r in (port, ref)]
        return [f"{st[0]} / {st[1]}"] + [""] * 5, ([] if st == ["skipped"] * 2
                                                 else ["status"])
    if port["status"] != ref["status"]:
        return [f"{port['status']} / {ref['status']}"] + [""] * 5, ["status"]
    pf, rf = port["dense_flops_per_device"], ref["hlo_flops_per_device"]
    pw = port["collectives"]["wire_bytes_per_device"]
    rw = ref["collectives"]["wire_bytes_per_device"]
    fr = pf / rf if rf else float("inf")
    wr = pw / rw if rw else (1.0 if pw == 0 else float("inf"))
    missed = []
    if fr > FLOP_LIMIT:
        missed.append("flops")
    if port["mode"] == "train" and wr > WIRE_LIMIT:
        missed.append("wire")
    if any(port.get(k) != ref.get(k) for k in BYTES):
        missed.append("bytes")
    return [f"{pf:.3e}", f"{rf:.3e}", f"{fr:.2f}", f"{pw:.3e}", f"{rw:.3e}",
            f"{wr:.2f}"], missed


def _load(path: Path):
    recs = {}
    for p in sorted(path.glob("*.json")):
        r = json.loads(p.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", default=str(ROOT / "artifacts" / "dryrun_torch"))
    ap.add_argument("--ref", default=str(ROOT / "artifacts" / "dryrun_reference"))
    args = ap.parse_args(argv)
    recs, refs = _load(Path(args.dir)), _load(Path(args.ref))
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.dryrun import all_cells
    cells = list(all_cells())

    cols = ["state GiB", "batch MiB", "cache GiB", "saved GiB", "FLOPs",
            "op bytes", "wire bytes", "fits 80 GB"]
    print("| arch | shape | " + " | ".join(f"{c} (s / m)" for c in cols) + " |")
    print("| --- | --- |" + " --- |" * len(cols))
    tally = {m: collections.Counter() for m in MESHES}
    for arch, shape in cells:
        got = {m: recs.get((arch, shape, m)) for m in MESHES}
        for m, r in got.items():
            tally[m][r["status"] if r else "missing"] += 1
        if all(r is not None and r["status"] == "skipped" for r in got.values()):
            continue
        row = [_cell(got[m]) for m in MESHES]
        print(f"| {arch} | {shape} | " + " | ".join(
            f"{a} / {b}" for a, b in zip(*row)) + " |")
    print("; ".join(f"{m}: " + ", ".join(f"{n} {s}" for s, n in sorted(t.items()))
                    for m, t in tally.items()))
    print()

    cols = ["port dense FLOPs", "ref FLOPs", "FLOPs ratio", "port wire bytes",
            "ref wire bytes", "wire ratio"]
    print("| arch | shape | " + " | ".join(f"{c} (s / m)" for c in cols)
          + " | missed |")
    print("| --- | --- |" + " --- |" * (len(cols) + 1))
    missed = {m: collections.Counter() for m in MESHES}
    for arch, shape in cells:
        pairs = {m: (recs.get((arch, shape, m)), refs.get((arch, shape, m)))
                 for m in MESHES}
        if all(p and r and p["status"] == r["status"] == "skipped"
               for p, r in pairs.values()):
            continue
        rows, miss = [], []
        for m, (port, ref) in pairs.items():
            row, ms = compare(port, ref)
            rows.append(row)
            for k in ms:
                missed[m][k] += 1
                miss.append(f"{k} ({m[0]})")
        print(f"| {arch} | {shape} | " + " | ".join(
            f"{a} / {b}" for a, b in zip(*rows)) + f" | {', '.join(miss) or '–'} |")
    print("; ".join(f"{m}: limits missed " + (", ".join(
        f"{k} {n}" for k, n in sorted(c.items())) or "none")
        for m, c in missed.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Run the JAX reference's own dry run, cell by cell, for the port's
comparison.

    python3 tools/dryrun_reference.py --arch phi3.5-moe-42b-a6.6b --shape train_4k --mesh single
    python3 tools/dryrun_reference.py --all [--mesh both] [--jobs 3] [--force]

Each cell runs ``repro.launch.dryrun.run_cell(arch, shape, mesh)`` in a jax
subprocess of its own with 512 forced host devices (``JAX_PLATFORMS=cpu``).
Inside that subprocess only, ``repro.launch.mesh.make_production_mesh`` is
replaced by one that builds the same mesh with ``AxisType.Auto`` axes: the
installed jax makes ``jax.make_mesh`` axes ``Explicit`` by default, which the
reference's ``with_sharding_constraint`` refuses.  Nothing in ``src/repro``
is edited.  The record is written to
``artifacts/dryrun_reference/<arch>__<shape>__<mesh>.json`` (the reference's
keys: ``hlo_flops_per_device``, ``collectives.wire_bytes_per_device``, the
per-device bytes, ``lower_s`` / ``compile_s``), or with ``status: error``
and the subprocess's last lines when it fails.

This is a tool of the test side: it imports ``repro``, which the package
``repro_torch`` and ``chip_smoke.py`` never do.  ``tools/dryrun_table.py``
prints the port's counts beside these.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "artifacts" / "dryrun_reference"

CELL = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.launch import mesh as M

def make_production_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))

M.make_production_mesh = make_production_mesh
from repro.launch.dryrun import run_cell
rec = run_cell(sys.argv[1], sys.argv[2], sys.argv[3], verbose=False)
print("RECORD " + json.dumps(rec))
"""


def artifact_path(arch: str, shape: str, mesh: str) -> Path:
    safe = arch.replace("/", "_").replace(".", "_")
    return OUT_DIR / f"{safe}__{shape}__{mesh}.json"


def run_one(arch: str, shape: str, mesh: str, timeout: int) -> dict:
    """One cell in its own jax subprocess; its record (or an error one)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    try:
        r = subprocess.run([sys.executable, "-c", CELL, arch, shape, mesh],
                           env=env, capture_output=True, text=True, timeout=timeout)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RECORD ")]
        if r.returncode == 0 and lines:
            rec = json.loads(lines[-1][len("RECORD "):])
        else:
            rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                   "error": (r.stderr or r.stdout)[-3000:]}
    except subprocess.TimeoutExpired:
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
               "error": f"timeout after {timeout} s"}
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="every (arch x shape) cell")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells that already have artifacts")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, one subprocess each")
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args(argv)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.launch.dryrun import all_cells   # the reference's list
        cells = [(a, s, m) for a, s in all_cells() for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, m) for m in meshes]
    if not args.force:
        cells = [c for c in cells if not artifact_path(*c).exists()]
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    def work(cell):
        rec = run_one(*cell, timeout=args.timeout)
        artifact_path(*cell).write_text(json.dumps(rec, indent=1) + "\n")
        extra = (f" dot FLOPs/device {rec['hlo_flops_per_device']:.4e}, wire bytes/device "
                 f"{rec['collectives']['wire_bytes_per_device']:.4e}"
                 if rec["status"] == "ok" else "")
        print(f"{'/'.join(cell)}: {rec['status']} in {rec['wall_s']} s{extra}", flush=True)
        return rec["status"]

    with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        statuses = list(pool.map(work, cells))
    return 1 if "error" in statuses else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""What every cell shares: finding its files by name, the card, the guard
against JAX, the numbers compared, and the result line.

A cell (``workloads`` in ``BENCHMARK.json``) names a configuration and a
traffic mix.  Each is a data file found by its name:

* ``configs/<config>.json``: the model as it is run (``model``), its
  source, and which reference computes it (``reference/<reference>.py``);
* ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  module that runs it, ``kinds/<kind>.py``;
* ``limits/<workload>.json``: each number the cell's check compares, with
  its limit;
* ``metrics/<metric>.py``: one per-layer metric, a ``read(readings)`` that
  returns its value or None where the run has nothing to read.

Adding a cell or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    here: Path = HERE


@dataclass
class Check:
    """One number compared, with its limit; passes at or under it."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a kind's run hands back to :func:`result`."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    readings: dict
    checks: List[Check]
    memory_peak_bytes: int
    notes: List[str] = field(default_factory=list)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, workload: str) -> bool:
    return workload in entry.get("workloads", [workload])


def load_cell(workload: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell named ``workload`` in ``root/BENCHMARK.json``, its files
    read from ``here``."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    w = cells[workload]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_json(here / "configs" / f"{w['config']}.json"),
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=_json(here / "limits" / f"{workload}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        here=here)


def kind(cell: Cell) -> ModuleType:
    k = cell.traffic["kind"]
    return load_module(cell.here / "kinds" / f"{k}.py", f"chipbench_kind_{k}")


def reference(cell: Cell) -> ModuleType:
    r = cell.config["reference"]
    return load_module(cell.here / "reference" / f"{r}.py", f"chipbench_ref_{r}")


def metric_reader(cell: Cell, name: str) -> ModuleType:
    return load_module(cell.here / "metrics" / f"{name}.py",
                       "chipbench_metric_" + name.replace(".", "_"))


def require_cards(n: int) -> None:
    """Exit without a result unless ``n`` CUDA cards are there."""
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        print(f"chipbench: needs {n} CUDA card(s), found {have}; no result",
              file=sys.stderr)
        raise SystemExit(2)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the run may not load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def cache_dirs(root: Path = ROOT) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the port's nvcc libraries already go to build/repro_torch)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ.setdefault(var, str(root / "build" / sub))
    os.environ.setdefault("USE_FLAX", "0")


def device_info(count: int, peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def result(cell: Cell, out: Outcome, trace: bool) -> dict:
    """The last line: ``--trace 0`` the cell's end-to-end metrics,
    ``--trace 1`` its per-layer ones (those whose reader finds something)."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(cell, m["name"]).read(out.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    device = device_info(cell.chips, out.memory_peak_bytes)
    line = {"correct": all(c.ok for c in out.checks) and bool(out.checks),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if trace:
        t = out.readings["trace"]
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
        line["breakdown"] = t["breakdown"]
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return line


def setup_note(start: float, marks: List[tuple]) -> str:
    """Set-up and its parts: ``marks`` are (what ended, when) in order,
    ``start`` the process's start."""
    parts, t = [], start
    for what, at in marks:
        parts.append(f"{what} {at - t:.3f}")
        t = at
    return f"setup {t - start:.3f} s ({', '.join(parts)})"


def check_lines(checks: List[Check]) -> str:
    return "\n".join(f"check {c.name} {c.value!r} limit {c.limit!r} "
                     f"{'ok' if c.ok else 'FAIL'}" for c in checks)

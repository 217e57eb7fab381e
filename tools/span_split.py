#!/usr/bin/env python3
"""The port's spans in one benchmark cell's traced window.

    python3 tools/span_split.py --workload starcoder2-train-2k --seed 7 --seconds 30

Runs the cell as ``chipbench/run.py --trace 1`` does (the same set-up,
window, check and result line) and reads the window's trace once more with
:func:`repro_torch.obs.split`, which the benchmark's own reading
(``chipbench/trace.finish``) does not call.  Then prints on stderr, in
device milliseconds a step (a train cell) or a request batch (prefill) and
as shares of the device's busy time: the train step's phases (forward,
backward, optimizer), the ingest, and what was launched outside both; the
time and operations of each of the port's other spans; and the window's
idle time by the span open as each gap starts.  The last line,
``span_split {...}``, holds the same numbers as JSON.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def summary(r: dict, units: int, unit: str) -> str:
    from repro_torch import obs
    busy = r["busy_s"]
    lines = [f"spans: {units} {unit}s; busy {busy / units * 1e3:.3f} ms a {unit} "
             f"of {r['window_s'] / units * 1e3:.3f}"]

    def row(what: str, s: float) -> None:
        lines.append(f"  {s / units * 1e3:10.3f} ms {s / busy * 100:6.2f}%  {what}")

    ingest = sum(r["span_s"].get(n, 0.0) for n in (obs.INGEST_READ, obs.INGEST_TO_DEVICE))
    if set(r["phase_s"]) - {"none"}:
        for p in (obs.FORWARD, obs.BACKWARD, obs.OPTIMIZER):
            row(f"phase {p}", r["phase_s"].get(p, 0.0))
        row("ingest (outside the phases)", ingest)
        row("none: outside the phases and the ingest", r["phase_s"].get("none", 0.0) - ingest)
    for n, s in sorted(r["span_s"].items()):
        if not n.startswith(obs.PHASE):
            where = "outside every span of the port" if n == "none" else f"span {n}"
            row(f"{where} ({r['span_launches'][n]} ops)", s)
    lines.append("idle by the span open as each gap starts:")
    for n, s in sorted(r["idle_by_span"].items(), key=lambda kv: -kv[1]):
        lines.append(f"  {s / units * 1e3:10.3f} ms a {unit}  {n}")
    return "\n".join(lines)


def main(argv=None) -> int:
    import torch
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chipbench import run, trace as tr
    from repro_torch import obs

    args = run.parse_args(argv)
    found = []
    finish = tr.finish

    def finish_and_split(prof, flash, top=10):
        out = finish(prof, flash, top)
        events = prof.profiler.kineto_results.events()
        host = [e for e in events if e.device_type() != torch.autograd.DeviceType.CUDA]
        w = next(e for e in host if e.name() == tr.WINDOW)
        w0, w1 = w.start_ns(), w.start_ns() + w.duration_ns()
        inside = [e.name() for e in host if w0 <= e.start_ns() < w1]
        units = inside.count(obs.OPTIMIZER) or inside.count(obs.PREFILL)
        found.append((obs.split(events, (w0, w1)),
                      units, "step" if inside.count(obs.OPTIMIZER) else "batch"))
        return out

    tr.finish = finish_and_split
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    for r, units, unit in found:
        print(summary(r, max(units, 1), unit), file=sys.stderr)
        print("span_split " + json.dumps({"units": units, "unit": unit, **r}),
              file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

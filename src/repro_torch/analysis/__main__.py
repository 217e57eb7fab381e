"""``python -m repro_torch.analysis`` — the static-analysis CLI.

Modes (combinable; all run when ``--smoke`` is given):

* ``--fig figN --model M``: run the figure's workloads on the M-layer
  with the execution tracer attached and race-check the lifted ledger
  under the M model spec (the paper's race-free claim for every trace
  we benchmark).  ``--full`` uses the paper-scale grids (fig7/fig8 at
  2048 clients); the default is a fast grid.
* ``--fuzz N [--seed S] [--minimize]``: seeded litmus fuzzing across
  all four layers (detector-vs-SC-oracle cross-check; see
  :mod:`repro_torch.analysis.litmus`).
* ``--lint``: the DES-invariant AST lint over src/benchmarks/examples.
* ``--smoke``: lint + fast-grid race checks of every figure + a small
  fuzz — the blocking CI gate (``make analyze-smoke``).

Exit status 0 iff every requested check passes.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.lint import run_lint
from repro_torch.analysis.litmus import fuzz
from repro_torch.analysis.racecheck import RaceReport, check_execution
from repro_torch.analysis.trace import ExecutionTracer
from repro_torch.core.model import MODELS, Execution

ALL_MODELS = ("posix", "commit", "session", "mpiio")

#: Max witnesses printed per racy report.
MAX_WITNESSES = 8


# -------------------------------------------------------------- fig runners
def _workload_exe(cfg, **kw) -> Execution:
    from repro_torch.io.workloads import run_workload
    tracer = ExecutionTracer()
    run_workload(cfg, tracer=tracer, **kw)
    return tracer.exe


def _fig3(model: str, full: bool) -> List[Tuple[str, Execution]]:
    from repro_torch.io.workloads import cn_w, sn_w
    n, p, m = (16, 12, 10) if full else (2, 2, 4)
    s = 8 * 1024
    return [(f"CN-W/{model}", _workload_exe(cn_w(n, s, model, p=p, m=m))),
            (f"SN-W/{model}", _workload_exe(sn_w(n, s, model, p=p, m=m)))]


def _fig4(model: str, full: bool) -> List[Tuple[str, Execution]]:
    from repro_torch.io.workloads import cc_r, cs_r
    n, p, m = (16, 12, 10) if full else (2, 2, 4)
    s = 8 * 1024
    return [(f"CC-R/{model}", _workload_exe(cc_r(n, s, model, p=p, m=m))),
            (f"CS-R/{model}", _workload_exe(cs_r(n, s, model, p=p, m=m)))]


def _fig5(model: str, full: bool) -> List[Tuple[str, Execution]]:
    from repro_torch.io.scr import SCRConfig, run_scr
    if model not in ("commit", "session"):
        return []
    n, p, particles = (17, 12, 10_000_000) if full else (3, 2, 24_000)
    tracer = ExecutionTracer()
    run_scr(SCRConfig(n=n, model=model, p=p, particles=particles),
            tracer=tracer)
    return [(f"SCR/{model}", tracer.exe)]


def _fig6(model: str, full: bool) -> List[Tuple[str, Execution]]:
    from repro_torch.data.dlio import PreloadedStore
    if model not in ("commit", "session", "mpiio"):
        return []
    hosts, per_host = (16, 128) if full else (2, 8)
    tracer = ExecutionTracer()
    store = PreloadedStore(model, hosts, per_host,
                           sample_bytes=116 * 1024, procs_per_host=4,
                           tracer=tracer)
    store.preload()
    store.run_epoch(0)
    return [(f"DL/{model}", tracer.exe)]


def _fig7(model: str, full: bool) -> List[Tuple[str, Execution]]:
    from repro_torch.io.workloads import rn_r
    # Full grid = the paper-scale saturated point: 128 nodes x 16 procs
    # = 2048 clients, 20480 data ops in one lifted execution.
    n, p, m = (128, 16, 10) if full else (4, 2, 4)
    return [(f"RN-R/{model}",
             _workload_exe(rn_r(n, 8 * 1024, model, p=p, m=m)))]


def _fig8(model: str, full: bool) -> List[Tuple[str, Execution]]:
    from repro_torch.io.workloads import rn_r_hot, rn_r_hot_set
    n, p, m = (128, 16, 10) if full else (2, 2, 4)
    s = 8 * 1024
    return [
        (f"RN-R-hot/{model}",
         _workload_exe(rn_r_hot(n, s, model, p=p, m=m))),
        (f"RN-R-hotset/{model}",
         _workload_exe(rn_r_hot_set(n, s, model, p=p, m=m))),
    ]


FIGS: Dict[str, Callable[[str, bool], List[Tuple[str, Execution]]]] = {
    "fig3": _fig3, "fig4": _fig4, "fig5": _fig5,
    "fig6": _fig6, "fig7": _fig7, "fig8": _fig8,
}


def analyze_fig(fig: str, models: List[str], full: bool,
                out: List[str]) -> bool:
    ok = True
    for model in models:
        t0 = time.perf_counter()
        runs = FIGS[fig](model, full)
        if not runs:
            out.append(f"{fig}/{model}: skipped (layer not benchmarked "
                       "in this figure)")
            continue
        for label, exe in runs:
            rep: RaceReport = check_execution(exe, MODELS[model])
            dt = time.perf_counter() - t0
            out.append(f"{fig} {label}: {rep.summary()}  [{dt:.1f}s]")
            if not rep.race_free:
                ok = False
                for race in rep.races[:MAX_WITNESSES]:
                    out.append(f"    {race}")
                if len(rep.races) > MAX_WITNESSES:
                    out.append(f"    ... {len(rep.races) - MAX_WITNESSES} "
                               "more")
    return ok


def do_lint(out: List[str]) -> bool:
    violations = run_lint()
    for v in violations:
        out.append(str(v))
    out.append(f"lint: {len(violations)} violation(s)")
    return not violations


def do_fuzz(n: int, seed: int, minimize: bool, out: List[str]) -> bool:
    res = fuzz(n=n, seed=seed, minimize=minimize)
    out.append(res.summary())
    for d in res.disagreements:
        out.append(str(d))
    return res.ok


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Trace-scale race analysis, litmus fuzzing and "
                    "DES-invariant lint.")
    ap.add_argument("--fig", choices=sorted(FIGS) + ["all"],
                    help="race-check this figure's workload traces")
    ap.add_argument("--model", default="all",
                    choices=list(ALL_MODELS) + ["all"],
                    help="consistency layer/model to run and check")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale grids (default: fast grids)")
    ap.add_argument("--fuzz", type=int, metavar="N", default=0,
                    help="fuzz N seeded litmus programs across all layers")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--minimize", action="store_true",
                    help="delta-debug fuzzer failures to minimal litmus "
                         "tests")
    ap.add_argument("--lint", action="store_true",
                    help="run the DES-invariant AST lint")
    ap.add_argument("--smoke", action="store_true",
                    help="blocking CI gate: lint + fast-grid race checks "
                         "+ small fuzz")
    ap.add_argument("--out", metavar="PATH",
                    help="also write the report to this file")
    args = ap.parse_args(argv)

    models = list(ALL_MODELS) if args.model == "all" else [args.model]
    out: List[str] = []
    ok = True
    ran = False
    if args.lint or args.smoke:
        ran = True
        ok &= do_lint(out)
    if args.fig or args.smoke:
        ran = True
        figs = sorted(FIGS) if args.smoke or args.fig == "all" \
            else [args.fig]
        for fig in figs:
            ok &= analyze_fig(fig, models, args.full and not args.smoke,
                              out)
    if args.fuzz or args.smoke:
        ran = True
        n = args.fuzz or 25
        ok &= do_fuzz(n, args.seed, args.minimize, out)
    if not ran:
        ap.print_help()
        return 2
    out.append("ANALYSIS " + ("PASS" if ok else "FAIL"))
    text = "\n".join(out)
    print(text)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

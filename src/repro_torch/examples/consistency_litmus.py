"""Storage-model litmus programs + the executable race checker (paper §4).

    PYTHONPATH=src python -m repro_torch.examples.consistency_litmus
    PYTHONPATH=src python -m repro_torch.examples.consistency_litmus --fuzz 200
    PYTHONPATH=src python -m repro_torch.examples.consistency_litmus --fuzz 50 --minimize

Ported from the reference's ``examples/consistency_litmus.py`` over the
port's copies of the analysis and model modules; framework-free, so it has
no ``--device``.

The default mode generates seeded litmus programs with the fuzzer
(:mod:`repro_torch.analysis.litmus`), runs each on all four consistency
layers, and cross-checks the race detector against the SC oracle — the
SCNF contract: race-free programs get sequentially consistent results;
racy programs get whatever the buffers hold.  ``--minimize`` also
delta-debugs a sample of racy programs down to their minimal racy core
and prints them — machine-generated litmus tests.  ``--zoo`` prints the
Table-4 model specs.
"""

import argparse
import random

from repro_torch.analysis.litmus import (
    FUZZ_MODELS, ddmin, format_program, fuzz, gen_program, run_litmus)
from repro_torch.core.model import MODELS


def fuzz_mode(n: int, seed: int, minimize: bool) -> int:
    print(f"== seeded litmus fuzz: {n} programs, seed={seed}, "
          f"layers={'/'.join(FUZZ_MODELS)} ==")
    res = fuzz(n=n, seed=seed, minimize=minimize)
    print(res.summary())
    for d in res.disagreements:
        print(d)
    if minimize and res.ok:
        # Nothing to minimize (the theorem held) — demonstrate the
        # minimizer on racy programs instead: shrink each to the
        # smallest program that still races under its model.
        print("\n== minimized racy cores (ddmin demo) ==")
        rng = random.Random(seed)
        shown = 0
        while shown < 3:
            prog = gen_program(rng)
            for model in FUZZ_MODELS:
                spec = MODELS[model]
                if not run_litmus(prog, model).storage_races(spec):
                    continue

                def still_racy(p, m=model, s=spec):
                    return bool(run_litmus(p, m).storage_races(s))

                small = ddmin(prog, still_racy)
                print(f"[{model}] {len(prog)} steps -> {len(small)}:")
                print(format_program(small))
                shown += 1
                break
    return 0 if res.ok else 1


def model_zoo() -> None:
    print("\n== Table 4: each model is just (S, MSC) ==")
    for name, spec in MODELS.items():
        mscs = "; ".join(
            " ".join(
                e.value if i % 2 == 0 else "|".join(sorted(k))
                for i, (e, k) in enumerate(
                    _interleave(m.edges, m.sync_kinds)))
            for m in spec.mscs)
        print(f"  {name:15s} S={sorted(spec.sync_ops) or '{}'}  MSC: {mscs}")


def _interleave(edges, kinds):
    res = []
    for i in range(len(edges) + len(kinds)):
        if i % 2 == 0:
            res.append((edges[i // 2], frozenset()))
        else:
            res.append((edges[0], kinds[i // 2]))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fuzz", type=int, metavar="N", default=20,
                    help="number of seeded litmus programs (default 20)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--minimize", action="store_true",
                    help="delta-debug racy programs to minimal cores")
    ap.add_argument("--zoo", action="store_true",
                    help="also print the Table-4 model specs")
    args = ap.parse_args(argv)
    rc = fuzz_mode(args.fuzz, args.seed, args.minimize)
    if args.zoo:
        model_zoo()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

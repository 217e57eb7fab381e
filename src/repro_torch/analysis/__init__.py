"""Static analysis over recorded executions (ROADMAP direction 3).

Three legs, layered strictly *above* :mod:`repro_torch.core` (core never
imports analysis at module scope; ``Execution.hb`` lazy-loads the
vector-clock engine, which is itself dependency-free and duck-typed):

* :mod:`repro_torch.analysis.vectorclock` — FastTrack-style vector-clock
  happens-before engine; O(1) ``hb`` queries after an incremental
  linear pass, replacing the O(n²) transitive-closure reachability
  sets for trace-scale executions.
* :mod:`repro_torch.analysis.racecheck` — interval-sweep storage-race
  detector + the ledger→Execution lift (:mod:`repro_torch.analysis.trace`)
  that race-checks real benchmark workloads (fig3–fig8 grids) against
  the paper's Table-4 model specs, with witness paths per race.
* :mod:`repro_torch.analysis.litmus` — seeded litmus-program fuzzer that
  cross-checks detector verdicts against the SC oracle on all four
  layers (race-free ⇒ SCNF must hold) and delta-debugs failures to
  minimal litmus tests; :mod:`repro_torch.analysis.lint` adds an AST pass
  enforcing the repo's DES invariants as a blocking CI gate.

``python -m repro_torch.analysis --help`` is the CLI over all of it.
"""

from repro_torch.analysis.vectorclock import VectorClockIndex  # noqa: F401

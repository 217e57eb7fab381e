"""The port's fault plane, formal model, checker and analysis plane
(``repro_torch.core.faults`` / ``model`` / ``checker``,
``repro_torch.analysis``) against the reference's.

* ``tests/test_faults.py``, ``test_vectorclock.py``, ``test_racecheck.py``,
  ``test_checker_property.py``, ``test_litmus_fuzzer.py`` and
  ``test_analysis_lint.py`` run here against the port, whole: their source
  is loaded with the reference's module prefixes read as the port's (and,
  for the lint's synthetic sources, ``src/repro/`` paths as
  ``src/repro_torch/``), so every case is theirs.  The lint's
  ``test_repo_is_lint_clean`` thereby runs the port's ``run_lint()`` over
  ``src/repro_torch``.
* ``fuzz`` at seed 0: the same 200 programs and the same verdict on every
  layer in both packages.
* Race reports, witnesses included, equal for the fast fig3 / fig4 / fig6
  traces, under every model's spec (a posix trace races under the others).
* The copied modules equal their reference modules apart from imports,
  ``repro.``-named docstring paths and the listed differences.
* ``python -m repro_torch.analysis --smoke`` exits 0.
"""

import os
import random
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis.__main__ as ref_cli
import repro.analysis.litmus as ref_litmus
import repro.analysis.racecheck as ref_racecheck
import repro.core.model as ref_model
import repro_torch.analysis.__main__ as port_cli
import repro_torch.analysis.litmus as port_litmus
import repro_torch.analysis.racecheck as port_racecheck
import repro_torch.core.model as port_model
from repro_torch.analysis.lint import lint_source, run_lint
from test_torch_core import _against_port, _plain

ROOT = Path(__file__).resolve().parents[1]
PREFIXES = tuple((f"repro.{m}", f"repro_torch.{m}")
                 for m in ("core", "io", "data", "analysis"))
MIRRORED = ("test_faults.py", "test_vectorclock.py", "test_racecheck.py",
            "test_checker_property.py", "test_litmus_fuzzer.py")


def _export(mod):
    """Every test function and class of ``mod``, under its own name."""
    for name, obj in vars(mod).items():
        if name.startswith(("test_", "Test")):
            assert name not in globals(), f"{name} is mirrored twice"
            globals()[name] = obj


for _filename in MIRRORED:
    _export(_against_port(_filename, PREFIXES))
_export(_against_port("test_analysis_lint.py",
                      PREFIXES + (("src/repro/", "src/repro_torch/"),)))


# --------------------------------------------------------------------------
# lint: the port's copy scans the port
# --------------------------------------------------------------------------
def test_lint_scans_the_port_and_nothing_else(tmp_path):
    bad = "def f(fs):\n    fs.bfs_query('/x')\n"
    for rel in ("src/repro_torch/io/x.py", "src/repro/io/x.py",
                "benchmarks/x.py", "examples/x.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(bad)
    v = run_lint(str(tmp_path))
    assert [(x.rule, x.path) for x in v] == [("ANA001", "src/repro_torch/io/x.py")]
    assert lint_source(bad, "src/repro_torch/core/consistency.py") == []
    assert [x.rule for x in lint_source(bad, "src/repro/core/consistency.py")] \
        == ["ANA001"]


# --------------------------------------------------------------------------
# fuzz and race reports against the reference
# --------------------------------------------------------------------------
def test_fuzz_seed_0_gives_the_same_programs_and_verdicts():
    ref_rng, port_rng = random.Random(0), random.Random(0)
    for _ in range(200):
        prog = ref_litmus.gen_program(ref_rng)
        assert port_litmus.gen_program(port_rng) == prog
        for model in ref_litmus.FUZZ_MODELS:
            assert (port_litmus.check_program(prog, model)
                    == ref_litmus.check_program(prog, model)), (model, prog)
    want, got = ref_litmus.fuzz(n=200, seed=0), port_litmus.fuzz(n=200, seed=0)
    assert (got.programs, got.runs, got.race_free_runs, got.summary()) == (
        want.programs, want.runs, want.race_free_runs, want.summary())
    assert got.ok and want.ok and got.programs == 200


def _report(rep):
    return (rep.summary(), rep.race_free,
            [(str(r), _plain(r.x.type), _plain(r.y.type)) for r in rep.races])


@pytest.mark.parametrize("model", ["posix", "commit", "session", "mpiio"])
@pytest.mark.parametrize("fig", ["fig3", "fig4", "fig6"])
def test_race_reports_match_the_reference(fig, model):
    want, got = ref_cli.FIGS[fig](model, False), port_cli.FIGS[fig](model, False)
    assert [label for label, _ in got] == [label for label, _ in want]
    witnesses, conflicts = 0, 0
    for (_, rexe), (_, pexe) in zip(want, got):
        for spec in ref_model.MODELS:
            r = ref_racecheck.check_execution(rexe, ref_model.MODELS[spec])
            p = port_racecheck.check_execution(pexe, port_model.MODELS[spec])
            assert _report(p) == _report(r), spec
            if spec == model:
                assert r.race_free       # every benchmarked trace is clean
            witnesses += len(r.races)
            conflicts += r.pairs_checked
    # Where a trace has conflicting pairs (fig4's and fig6's readers; fig3's
    # writers touch disjoint ranges), another model's spec finds races, so
    # witnesses were compared.
    assert (witnesses > 0) == (conflicts > 0)


# --------------------------------------------------------------------------
# the copies
# --------------------------------------------------------------------------
COPIES = ("io/workloads.py", "io/scr.py", "io/__init__.py", "data/dlio.py",
          "core/faults.py", "core/model.py", "core/checker.py",
          "analysis/vectorclock.py", "analysis/racecheck.py",
          "analysis/trace.py", "analysis/litmus.py", "analysis/lint.py",
          "analysis/__init__.py", "analysis/__main__.py")
#: Every other difference of a copy from its reference, as (regular
#: expression, replacement): the faults docstring names the goldens without
#: the reference's change numbers, and the lint scans the port.
DIFFERENCES = {
    "core/faults.py": [(r"to the \S+ goldens", "to the fault-free goldens")],
    "analysis/lint.py": [(re.escape(old), new) for old, new in (
        ('"src/repro/core/', '"src/repro_torch/core/'),
        ('SCAN_DIRS = ("src/repro", "benchmarks", "examples")',
         'SCAN_DIRS = ("src/repro_torch",)'),
        ("# src/repro/analysis/lint.py", "# src/repro_torch/analysis/lint.py"),
        ("on any.\n\"\"\"",
         "on any.\n\nThis copy lints the port.  Its one difference from "
         "``repro.analysis.lint``\nis the paths: :data:`SCAN_DIRS` is "
         "``src/repro_torch`` (the port's examples\nlive inside the "
         "package), and the allow-lists name the port's own\n"
         "``src/repro_torch/core/consistency.py``, ``basefs.py`` and "
         "``faults.py``.\n\"\"\""),
    )],
}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_reference_module(rel):
    want = re.sub(r"\brepro\.", "repro_torch.",
                  (ROOT / "src" / "repro" / rel).read_text())
    for pattern, new in DIFFERENCES.get(rel, ()):
        want, n = re.subn(pattern, lambda _: new, want)
        assert n > 0, (rel, pattern)
    assert (ROOT / "src" / "repro_torch" / rel).read_text() == want


def test_analysis_smoke_cli_passes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           "--smoke"], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.rstrip().endswith("ANALYSIS PASS")
    assert "lint: 0 violation(s)" in proc.stdout

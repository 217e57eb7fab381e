"""Seeded litmus-program fuzzer + delta-debugging minimizer (§4 checks).

A *litmus program* is a flat list of steps ``(pid, action)``::

    ("w", off, ln)    write len bytes at offset
    ("r", off, ln)    read
    ("sync1",)        producer-side fence: commit / session_close /
                      file_sync under the commit / session / mpiio
                      layer; a no-op under posix (S = ∅)
    ("sync2",)        consumer-side fence: session_open / file_sync;
                      no-op under posix and commit
    ("barrier",)      MPI_Barrier over every pid in the program
    ("send", tag)     MPI point-to-point: one so edge per matched
    ("recv", tag)     (send, recv) tag pair, in issue order

The same program runs on all four consistency layers through
:class:`~repro_torch.core.checker.TracedRun`.  For each layer the fuzzer
cross-checks three things:

1. **Detector golden equivalence** — the scalable
   :mod:`repro_torch.analysis.racecheck` detector and the reference
   ``Execution.storage_races`` agree on the race set;
2. **SCNF** (the paper's central theorem) — if the program is race-free
   under the layer's own model, the SC read oracle must pass;
3. any failure is **delta-debugged** (classic ddmin over the step list)
   down to a minimal program that still fails, which is the litmus test
   a human gets to stare at.

The commit layer is checked against the strict COMMIT model only: the
relaxed variant (hb commit hb) admits *proxy* commits, which our
CommitFS — like most commit AFSs — does not publish on behalf of
another client, so relaxed-race-free programs are not SC-guaranteed on
this layer (§4.2.2 discusses exactly this gap).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.racecheck import race_pairs
from repro_torch.core.checker import TracedRun
from repro_torch.core.consistency import LAYERS
from repro_torch.core.model import MODELS, ModelSpec

Step = Tuple[int, tuple]
Program = List[Step]

F = "/litmus"

#: Layers the fuzzer drives, each against its own Table-4 spec.
FUZZ_MODELS = ("posix", "commit", "session", "mpiio")


def _payload(pid: int, start: int, ln: int) -> bytes:
    return bytes(((pid * 37 + start + i) % 251 + 1) for i in range(ln))


# --------------------------------------------------------------- generation
def gen_program(rng: random.Random, n_pids: int = 3,
                max_steps: int = 14, domain: int = 64) -> Program:
    """One random multi-client program over a small offset domain.

    The domain is deliberately tiny so conflicting (overlapping,
    cross-process) accesses are common: most generated programs are racy
    under at least one model, which is what exercises both detector
    paths; barrier/send/recv steps produce the synchronized minority.
    """
    prog: Program = []
    n = rng.randint(4, max_steps)
    sent: List[int] = []
    tag = 0
    for _ in range(n):
        pid = rng.randrange(n_pids)
        roll = rng.random()
        if roll < 0.30:
            off = rng.randrange(domain)
            prog.append((pid, ("w", off, rng.randint(1, 16))))
        elif roll < 0.55:
            off = rng.randrange(domain)
            prog.append((pid, ("r", off, rng.randint(1, 16))))
        elif roll < 0.70:
            prog.append((pid, ("sync1",)))
        elif roll < 0.80:
            prog.append((pid, ("sync2",)))
        elif roll < 0.90:
            prog.append((pid, ("barrier",)))
        elif sent and roll < 0.95:
            prog.append((pid, ("recv", rng.choice(sent))))
        else:
            prog.append((pid, ("send", tag)))
            sent.append(tag)
            tag += 1
    return prog


def format_program(prog: Program) -> str:
    return "\n".join(f"  p{pid}: {' '.join(str(a) for a in act)}"
                     for pid, act in prog)


# ---------------------------------------------------------------- execution
def run_litmus(prog: Program, model: str) -> TracedRun:
    """Execute the program on the ``model`` layer, tracing the formal
    execution.  Robust against arbitrary sub-programs (ddmin slices):
    unmatched recvs, single-pid barriers and fences without prior
    writes are all legal no-ops or harmless calls.
    """
    run = TracedRun(LAYERS[model]())
    handles: Dict[int, object] = {}
    pids = sorted({pid for pid, _ in prog})
    pending_sends: Dict[int, object] = {}

    def fh(pid: int):
        if pid not in handles:
            handles[pid] = run.open(pid, F, node=pid)
        return handles[pid]

    for pid, act in prog:
        kind = act[0]
        if kind == "w":
            _, off, ln = act
            run.write_at(pid, fh(pid), off, _payload(pid, off, ln))
        elif kind == "r":
            _, off, ln = act
            run.read_at(pid, fh(pid), off, ln)
        elif kind == "sync1":
            if model == "commit":
                run.commit(pid, fh(pid))
            elif model == "session":
                run.session_close(pid, fh(pid))
            elif model == "mpiio":
                run.file_sync(pid, fh(pid))
        elif kind == "sync2":
            if model == "session":
                run.session_open(pid, fh(pid))
            elif model == "mpiio":
                run.file_sync(pid, fh(pid))
        elif kind == "barrier":
            if len(pids) > 1:
                run.barrier(pids)
        elif kind == "send":
            # The send op is recorded at ITS program point; the so edge
            # attaches when (if) a recv matches the tag later.
            pending_sends[act[1]] = run.exe.sync(pid, "", "send")
        elif kind == "recv":
            s = pending_sends.pop(act[1], None)
            if s is not None and s.pid != pid:
                r = run.exe.sync(pid, "", "recv")
                run.exe.add_so(s, r)
        else:  # pragma: no cover - generator never emits others
            raise ValueError(f"unknown litmus action {act!r}")
    return run


# ------------------------------------------------------------ cross-checking
@dataclass
class Disagreement:
    """One fuzzer finding: which check failed, on what, minimized."""

    model: str
    kind: str          # "golden" | "scnf"
    detail: str
    program: Program
    minimized: Optional[Program] = None

    def __str__(self) -> str:
        lines = [f"[{self.model}] {self.kind}: {self.detail}",
                 "program:", format_program(self.program)]
        if self.minimized is not None:
            lines += ["minimized:", format_program(self.minimized)]
        return "\n".join(lines)


@dataclass
class FuzzResult:
    programs: int = 0
    runs: int = 0
    race_free_runs: int = 0
    disagreements: List[Disagreement] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.disagreements

    def summary(self) -> str:
        verdict = "OK" if self.ok else f"{len(self.disagreements)} FAILURES"
        return (f"fuzz: {self.programs} programs x {len(FUZZ_MODELS)} "
                f"layers = {self.runs} runs "
                f"({self.race_free_runs} race-free) -> {verdict}")


def check_program(prog: Program, model: str
                  ) -> Tuple[Optional[Tuple[str, str]], bool]:
    """Run one (program, layer) pair.

    Returns ``(failure, race_free)``: ``failure`` is ``None`` or a
    ``(kind, detail)`` pair; ``race_free`` is the detector verdict under
    the layer's own model.
    """
    spec: ModelSpec = MODELS[model]
    run = run_litmus(prog, model)
    ref = {frozenset((x.op_id, y.op_id))
           for x, y in run.exe.storage_races(spec)}
    fast = race_pairs(run.exe, spec)
    if fast != ref:
        return (("golden",
                 f"detector={sorted(map(sorted, fast))} "
                 f"reference={sorted(map(sorted, ref))}"), not ref)
    if not ref:
        violations = run.check_sc()
        if violations:
            return (("scnf",
                     f"race-free but SC violated: {violations}"), True)
        return (None, True)
    return (None, False)


def fuzz(n: int = 200, seed: int = 0, minimize: bool = False,
         models: Sequence[str] = FUZZ_MODELS) -> FuzzResult:
    """Generate ``n`` seeded programs; cross-check every layer; minimize
    any failure.  The acceptance bar: zero disagreements."""
    rng = random.Random(seed)
    res = FuzzResult()
    for _ in range(n):
        prog = gen_program(rng)
        res.programs += 1
        for model in models:
            res.runs += 1
            failure, race_free = check_program(prog, model)
            if race_free:
                res.race_free_runs += 1
            if failure is None:
                continue
            kind, detail = failure
            dis = Disagreement(model, kind, detail, prog)
            if minimize:
                dis.minimized = ddmin(
                    prog,
                    lambda p, m=model: check_program(p, m)[0] is not None)
            res.disagreements.append(dis)
    return res


# ------------------------------------------------------------- minimization
def ddmin(prog: Program, failing: Callable[[Program], bool]) -> Program:
    """Classic delta debugging: a 1-minimal sub-program still failing.

    ``failing(prog)`` must be True on entry; the result is a subsequence
    on which ``failing`` still holds but removing any single step makes
    it pass.
    """
    assert failing(prog), "ddmin needs a failing input"
    n = 2
    while len(prog) >= 2:
        chunk = max(1, len(prog) // n)
        reduced = None
        # Try removing each chunk (complement testing).
        for i in range(0, len(prog), chunk):
            candidate = prog[:i] + prog[i + chunk:]
            if candidate and failing(candidate):
                reduced = candidate
                break
        if reduced is not None:
            prog = reduced
            n = max(n - 1, 2)
        elif chunk == 1:
            break
        else:
            n = min(n * 2, len(prog))
    return prog

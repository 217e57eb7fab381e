"""Ledger-scale storage-race detection (paper §4.1 at benchmark scale).

:class:`RaceChecker` reimplements
:meth:`repro_torch.core.model.Execution.storage_races` for trace-scale
executions:

* **Conflicting-pair enumeration** is an interval sweep per file — data
  ops sorted by range start, separate active write/read sets pruned by
  range end — so only genuinely overlapping cross-process pairs are
  visited (the O(n²) all-pairs loop never runs).  Reads are never paired
  with reads, so hot-region read pile-ups (fig8) stay linear.
* **Properly-synchronized checks** use closed-form MSC fast paths per
  Table-4 model, each O(log n) candidate lookups + O(1) vector-clock
  ``hb`` queries.  By po-monotonicity these are sound *and* complete:
  e.g. for session, if ANY (s1 = close po-after X, s2 = open po-before
  Y) pair satisfies hb(s1, s2), then the earliest close / latest open
  pair does.  Models outside the paper's five fall back to the generic
  ``Execution.msc_between`` search.

``check_execution(exe, spec)`` returns a :class:`RaceReport`; every race
carries a human-readable witness explaining which MSC element is
missing.  Golden equivalence against ``Execution.storage_races`` is
pinned in ``tests/test_racecheck.py``.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from heapq import heappop, heappush
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.model import Execution, ModelSpec, Op, OpType

#: Fast-path MSC tables: model name -> (S1 kinds, S2 kinds).  S2 = None
#: means the MSC ends directly in an hb edge after the single sync op
#: (commit), () means no sync ops at all (posix: plain hb).
_S1_S2: Dict[str, Tuple[Tuple[str, ...], Optional[Tuple[str, ...]]]] = {
    "posix": ((), None),
    "commit": (("commit",), None),
    "session": (("session_close",), ("session_open",)),
    "mpiio": (("file_close", "file_sync"), ("file_sync", "file_open")),
}


def _fmt(op: Op) -> str:
    if op.type is OpType.SYNC:
        return f"{op.kind} p{op.pid}#{op.seq} {op.obj}"
    return (f"{op.type.value} p{op.pid}#{op.seq} "
            f"{op.obj}[{op.start},{op.end})")


@dataclass
class Race:
    """One conflicting, unsynchronized pair plus its witness."""

    x: Op
    y: Op
    witness: str

    def __str__(self) -> str:
        return f"RACE {_fmt(self.x)} || {_fmt(self.y)}: {self.witness}"


@dataclass
class RaceReport:
    model: str
    n_ops: int
    n_data: int
    n_sync: int
    n_so_edges: int
    pairs_checked: int
    races: List[Race] = field(default_factory=list)

    @property
    def race_free(self) -> bool:
        return not self.races

    def summary(self) -> str:
        verdict = ("race-free" if self.race_free
                   else f"{len(self.races)} race(s)")
        return (f"[{self.model}] {self.n_ops} ops "
                f"({self.n_data} data, {self.n_sync} sync), "
                f"{self.n_so_edges} so edges, "
                f"{self.pairs_checked} conflicting pairs -> {verdict}")


class RaceChecker:
    """Scalable storage-race detector over one (Execution, ModelSpec)."""

    def __init__(self, exe: Execution, spec: ModelSpec) -> None:
        self.exe = exe
        self.spec = spec
        # (pid, obj, kind) -> parallel (seqs, ops), both in seq order —
        # Execution appends per-process ops in increasing seq, so the
        # natural order is already sorted.
        self._idx: Dict[Tuple[int, str, str], Tuple[List[int], List[Op]]] = {}
        self._by_obj_kind: Dict[Tuple[str, str], List[Op]] = {}
        for op in exe.ops:
            if op.type is OpType.SYNC and op.kind in spec.sync_ops:
                seqs, ops = self._idx.setdefault(
                    (op.pid, op.obj, op.kind), ([], []))
                seqs.append(op.seq)
                ops.append(op)
                self._by_obj_kind.setdefault((op.obj, op.kind), []).append(op)

    # ------------------------------------------------------------ MSC tools
    def _earliest_after(self, pid: int, obj: str, kinds: Sequence[str],
                        seq: int) -> Optional[Op]:
        best: Optional[Op] = None
        for kind in kinds:
            entry = self._idx.get((pid, obj, kind))
            if not entry:
                continue
            seqs, ops = entry
            j = bisect_right(seqs, seq)
            if j < len(ops) and (best is None or ops[j].seq < best.seq):
                best = ops[j]
        return best

    def _latest_before(self, pid: int, obj: str, kinds: Sequence[str],
                       seq: int) -> Optional[Op]:
        best: Optional[Op] = None
        for kind in kinds:
            entry = self._idx.get((pid, obj, kind))
            if not entry:
                continue
            seqs, ops = entry
            j = bisect_left(seqs, seq)
            if j > 0 and (best is None or ops[j - 1].seq > best.seq):
                best = ops[j - 1]
        return best

    def _ps(self, x: Op, y: Op) -> Tuple[bool, str]:
        """Properly-synchronized check, X → Y direction, with witness."""
        exe, spec = self.exe, self.spec
        if x.type is OpType.READ:
            # §4.1 rule 1: a read conflicting with a later op needs hb only.
            if exe.hb(x, y):
                return True, "read-first pair ordered by hb"
            return False, "read-first pair not ordered by hb"
        if spec.name == "commit_relaxed":
            c = self._earliest_after(x.pid, x.obj, ("commit",), x.seq)
            if c is not None and exe.hb(c, y):
                return True, f"via {_fmt(c)}"
            for c in self._by_obj_kind.get((x.obj, "commit"), ()):
                if exe.hb(x, c) and exe.hb(c, y):
                    return True, f"via proxy {_fmt(c)}"
            return False, ("no commit on the object is both hb-after the "
                           "write and hb-before the successor")
        if spec.name in _S1_S2:
            s1_kinds, s2_kinds = _S1_S2[spec.name]
            if not s1_kinds:  # posix: MSC is a bare hb edge
                if exe.hb(x, y):
                    return True, "hb (S = ∅)"
                return False, "not ordered by hb (S = ∅)"
            s1 = self._earliest_after(x.pid, x.obj, s1_kinds, x.seq)
            if s1 is None:
                return False, (f"no {'/'.join(s1_kinds)} by p{x.pid} on "
                               f"{x.obj} po-after the write")
            if s2_kinds is None:  # commit: ... s1 --hb--> Y
                if exe.hb(s1, y):
                    return True, f"via {_fmt(s1)}"
                return False, (f"{_fmt(s1)} does not reach the successor "
                               "in hb")
            s2 = self._latest_before(y.pid, y.obj, s2_kinds, y.seq)
            if s2 is None:
                return False, (f"no {'/'.join(s2_kinds)} by p{y.pid} on "
                               f"{y.obj} po-before the successor")
            if exe.hb(s1, s2):
                return True, f"via {_fmt(s1)} --hb--> {_fmt(s2)}"
            return False, (f"{_fmt(s1)} not hb-before {_fmt(s2)}")
        # Generic fallback for non-paper MSC shapes.
        syncs = [o for o in exe.ops if o.type is OpType.SYNC
                 and o.kind in spec.sync_ops]
        if any(exe.msc_between(m, x, y, syncs) for m in spec.mscs):
            return True, "generic MSC search"
        return False, "no MSC instantiates (generic search)"

    # ------------------------------------------------------------- sweeping
    def conflicting_pairs(self) -> List[Tuple[Op, Op]]:
        """All cross-process conflicting data-op pairs, via interval sweep."""
        by_obj: Dict[str, List[Op]] = {}
        for op in self.exe.ops:
            if op.is_data:
                by_obj.setdefault(op.obj, []).append(op)
        pairs: List[Tuple[Op, Op]] = []
        for ops in by_obj.values():
            ops.sort(key=lambda o: (o.start, o.op_id))
            active_w: List[Tuple[int, int, Op]] = []  # min-heap by end
            active_r: List[Tuple[int, int, Op]] = []
            for op in ops:
                while active_w and active_w[0][0] <= op.start:
                    heappop(active_w)
                while active_r and active_r[0][0] <= op.start:
                    heappop(active_r)
                # Every surviving active op overlaps: its start ≤ op.start
                # (sort order) and its end > op.start (heap prune), and
                # op.start < op.end always.
                if op.type is OpType.WRITE:
                    for _, _, a in active_w:
                        if a.pid != op.pid:
                            pairs.append((a, op))
                    for _, _, a in active_r:
                        if a.pid != op.pid:
                            pairs.append((a, op))
                    heappush(active_w, (op.end, op.op_id, op))
                else:
                    for _, _, a in active_w:
                        if a.pid != op.pid:
                            pairs.append((a, op))
                    heappush(active_r, (op.end, op.op_id, op))
        return pairs

    def races(self, pairs: Optional[List[Tuple[Op, Op]]] = None) -> List[Race]:
        exe = self.exe
        out: List[Race] = []
        if pairs is None:
            pairs = self.conflicting_pairs()
        for a, b in pairs:
            # Orient like the reference: creation order first, then hb.
            x, y = (a, b) if a.op_id < b.op_id else (b, a)
            if exe.hb(x, y):
                ok, why = self._ps(x, y)
                order = "hb-ordered"
            elif exe.hb(y, x):
                ok, why = self._ps(y, x)
                order = "hb-ordered (reverse)"
            else:
                ok, why = self._ps(x, y)
                if not ok:
                    ok, why2 = self._ps(y, x)
                    why = f"{why}; reverse: {why2}"
                order = "hb-unordered"
            if not ok:
                out.append(Race(x, y, f"{order}; {why}"))
        return out

    def report(self) -> RaceReport:
        pairs = self.conflicting_pairs()
        races = self.races(pairs)
        n_data = sum(1 for o in self.exe.ops if o.is_data)
        n_sync = sum(1 for o in self.exe.ops if o.type is OpType.SYNC)
        return RaceReport(
            model=self.spec.name,
            n_ops=len(self.exe.ops),
            n_data=n_data,
            n_sync=n_sync,
            n_so_edges=len(self.exe.so_edges),
            pairs_checked=len(pairs),
            races=races,
        )


def check_execution(exe: Execution, spec: ModelSpec) -> RaceReport:
    """Race-check one execution under one model spec (scalable path)."""
    return RaceChecker(exe, spec).report()


def race_pairs(exe: Execution, spec: ModelSpec) -> set:
    """Unordered race pair ids — for golden comparison in tests."""
    return {frozenset((r.x.op_id, r.y.op_id))
            for r in RaceChecker(exe, spec).races()}

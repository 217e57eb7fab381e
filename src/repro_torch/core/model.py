"""Executable form of the paper's formal framework (§4, Table 4).

An *execution* is a set of :class:`Op` records (data + synchronization
storage operations) with a program order (implicit: per-process sequence
numbers) and an explicit synchronization order (so edges between ops of
distinct processes, e.g. an MPI send/recv pair or a barrier).

A consistency model is specified exactly as in the paper: a set ``S`` of
synchronization-operation kinds and a list of Minimum Synchronization
Constructs.  An MSC is a sequence of k sync-op *patterns* and k+1 edge
kinds (po or hb)::

    MSC = --r0--> S1 --r1--> S2 --r2--> ... --r(k-1)--> Sk --rk-->

Two conflicting data ops X (write) and Y are *properly synchronized* iff
some MSC instantiates between them:  X --r0--> s1 --r1--> ... --rk--> Y
with each ``po`` edge additionally requiring same-process adjacency in
program order and each ``hb`` edge requiring happens-before.  A read X
conflicting with a later op Y needs only X -hb-> Y (§4.1 rule 1).

This module is pure logic — no I/O.  :mod:`repro_torch.core.checker` wires it to
recorded BaseFS traces.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from enum import Enum
from typing import Dict, FrozenSet, Iterable, List, Set, Tuple


class OpType(Enum):
    READ = "read"
    WRITE = "write"
    SYNC = "sync"


@dataclass(frozen=True)
class Op:
    """One executed storage operation.

    ``kind``  for SYNC ops: the model-specific operation name
              ("commit", "session_open", "session_close", "file_sync", ...).
    ``obj``   the synchronization object (file path).
    ``start/end`` access range for data ops (ignored for sync ops).
    """

    op_id: int
    pid: int
    seq: int              # per-process program-order index
    type: OpType
    obj: str
    start: int = 0
    end: int = 0
    kind: str = ""

    @property
    def is_data(self) -> bool:
        return self.type in (OpType.READ, OpType.WRITE)

    def conflicts(self, other: "Op") -> bool:
        """Paper: ranges overlap on the same object, at least one write."""
        if not (self.is_data and other.is_data):
            return False
        if self.obj != other.obj:
            return False
        if self.type is OpType.READ and other.type is OpType.READ:
            return False
        return self.start < other.end and other.start < self.end


class EdgeKind(Enum):
    PO = "po"
    HB = "hb"


@dataclass(frozen=True)
class MSC:
    """Minimum Synchronization Construct: sync-op patterns + edge kinds.

    ``sync_kinds[i]`` may be a single kind or a frozenset of alternatives
    (MPI-IO's s1/s2 sets).  ``edges`` has length ``len(sync_kinds) + 1``.
    """

    sync_kinds: Tuple[FrozenSet[str], ...]
    edges: Tuple[EdgeKind, ...]

    def __post_init__(self) -> None:
        if len(self.edges) != len(self.sync_kinds) + 1:
            raise ValueError("MSC needs k sync ops and k+1 edges")

    @staticmethod
    def of(*parts: object) -> "MSC":
        """Build from an alternating edge/sync sequence.

        ``MSC.of("po", "session_close", "hb", "session_open", "po")``
        """
        edges: List[EdgeKind] = []
        kinds: List[FrozenSet[str]] = []
        for i, p in enumerate(parts):
            if i % 2 == 0:
                edges.append(EdgeKind(p))
            else:
                kinds.append(
                    frozenset([p]) if isinstance(p, str) else frozenset(p)
                )
        return MSC(tuple(kinds), tuple(edges))


@dataclass(frozen=True)
class ModelSpec:
    """A properly-synchronized SCNF model = (S, MSCs) — paper Table 4."""

    name: str
    sync_ops: FrozenSet[str]
    mscs: Tuple[MSC, ...]


# ---------------------------------------------------------------------------
# Table 4 — the four models, verbatim.
# ---------------------------------------------------------------------------
POSIX_MODEL = ModelSpec(
    name="posix",
    sync_ops=frozenset(),
    mscs=(MSC.of("hb"),),
)

# Strict commit: the commit must be issued by the writing process (po).
COMMIT_MODEL = ModelSpec(
    name="commit",
    sync_ops=frozenset({"commit"}),
    mscs=(MSC.of("po", "commit", "hb"),),
)

# Relaxed commit variant (§4.2.2): any process may commit on the writer's
# behalf, provided the commit is hb-after the write.
COMMIT_RELAXED_MODEL = ModelSpec(
    name="commit_relaxed",
    sync_ops=frozenset({"commit"}),
    mscs=(MSC.of("hb", "commit", "hb"),),
)

SESSION_MODEL = ModelSpec(
    name="session",
    sync_ops=frozenset({"session_close", "session_open"}),
    mscs=(MSC.of("po", "session_close", "hb", "session_open", "po"),),
)

_MPI_S1 = frozenset({"file_close", "file_sync"})
_MPI_S2 = frozenset({"file_sync", "file_open"})
MPIIO_MODEL = ModelSpec(
    name="mpiio",
    sync_ops=frozenset({"file_open", "file_close", "file_sync"}),
    mscs=(MSC.of("po", _MPI_S1, "hb", _MPI_S2, "po"),),
)

MODELS: Dict[str, ModelSpec] = {
    m.name: m
    for m in (
        POSIX_MODEL,
        COMMIT_MODEL,
        COMMIT_RELAXED_MODEL,
        SESSION_MODEL,
        MPIIO_MODEL,
    )
}


# ---------------------------------------------------------------------------
# Execution: ops + so edges; hb = transitive closure of (po ∪ so).
# ---------------------------------------------------------------------------
class Execution:
    """A recorded execution over which races are checked."""

    def __init__(self) -> None:
        self.ops: List[Op] = []
        self.so_edges: List[Tuple[int, int]] = []  # (op_id, op_id)
        self._op_counter = itertools.count()
        self._seq: Dict[int, itertools.count] = {}
        # Lazy vector-clock hb index (repro_torch.analysis.vectorclock).  It
        # holds live references to ``ops``/``so_edges`` and re-syncs
        # incrementally at query time, so ``add``/``add_so`` never
        # invalidate it wholesale — see the hb() docstring for the
        # contract.
        self._vc = None

    # ---- construction ----
    def _next_seq(self, pid: int) -> int:
        return next(self._seq.setdefault(pid, itertools.count()))

    def add(self, pid: int, type: OpType, obj: str, start: int = 0,
            end: int = 0, kind: str = "") -> Op:
        op = Op(
            next(self._op_counter), pid, self._next_seq(pid), type, obj,
            start, end, kind,
        )
        self.ops.append(op)
        return op

    def read(self, pid: int, obj: str, start: int, end: int) -> Op:
        return self.add(pid, OpType.READ, obj, start, end)

    def write(self, pid: int, obj: str, start: int, end: int) -> Op:
        return self.add(pid, OpType.WRITE, obj, start, end)

    def sync(self, pid: int, obj: str, kind: str) -> Op:
        return self.add(pid, OpType.SYNC, obj, kind=kind)

    def add_so(self, a: Op, b: Op) -> None:
        """a --so--> b, between distinct processes (paper §4.1)."""
        if a.pid == b.pid:
            raise ValueError("so edges connect distinct processes")
        self.so_edges.append((a.op_id, b.op_id))

    # ---- orders ----
    def po(self, a: Op, b: Op) -> bool:
        return a.pid == b.pid and a.seq < b.seq

    def _build_hb(self) -> List[Set[int]]:
        """Reachability sets over po ∪ so via reverse-toposort DP.

        po ∪ so must be acyclic (so is consistent with po by definition);
        we verify acyclicity while sorting.

        This is the O(n²) *reference* oracle: ``hb()`` answers through
        the vector-clock index instead, and the golden/property tests in
        ``tests/test_vectorclock.py`` pin the two equal.
        """
        n = len(self.ops)
        succ: List[List[int]] = [[] for _ in range(n)]
        indeg = [0] * n
        by_pid: Dict[int, List[Op]] = {}
        for op in self.ops:
            by_pid.setdefault(op.pid, []).append(op)
        for ops in by_pid.values():
            ops.sort(key=lambda o: o.seq)
            for a, b in zip(ops, ops[1:]):
                succ[a.op_id].append(b.op_id)
                indeg[b.op_id] += 1
        for a_id, b_id in self.so_edges:
            succ[a_id].append(b_id)
            indeg[b_id] += 1
        # Kahn topo order.
        order: List[int] = [i for i in range(n) if indeg[i] == 0]
        head = 0
        while head < len(order):
            u = order[head]
            head += 1
            for v in succ[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    order.append(v)
        if len(order) != n:
            raise ValueError("po ∪ so contains a cycle")
        reach: List[Set[int]] = [set() for _ in range(n)]
        for u in reversed(order):
            for v in succ[u]:
                reach[u].add(v)
                reach[u] |= reach[v]
        return reach

    def hb(self, a: Op, b: Op) -> bool:
        """a happens-before b (transitive po ∪ so).

        Answered by the incremental vector-clock index
        (:class:`repro_torch.analysis.vectorclock.VectorClockIndex`): the
        first query pays one linear pass; ``add`` extends the index
        lazily and ``add_so`` re-derives at most the suffix from the
        edge's target onward, so interleaving construction with queries
        never rebuilds the full index (the closure-cache footgun this
        replaces).  ``hb_stats()`` exposes the pass counters.
        """
        if a.pid == b.pid:
            return a.seq < b.seq
        if self._vc is None:
            from repro_torch.analysis.vectorclock import VectorClockIndex
            self._vc = VectorClockIndex(self.ops, self.so_edges)
        return self._vc.hb(a, b)

    def hb_stats(self) -> Dict[str, int]:
        """Vector-clock index counters (zeros before the first query)."""
        if self._vc is None:
            return {"ops_indexed": 0, "ops_processed": 0, "full_builds": 0}
        return self._vc.stats()

    # ---- MSC matching ----
    def _edge_holds(self, kind: EdgeKind, a: Op, b: Op) -> bool:
        if kind is EdgeKind.PO:
            return self.po(a, b)
        return self.hb(a, b)

    def msc_between(self, msc: MSC, x: Op, y: Op,
                    sync_ops: Iterable[Op]) -> bool:
        """Does ``msc`` instantiate between x and y (same sync object)?"""
        candidates = [
            [
                s
                for s in sync_ops
                if s.kind in kinds and s.obj == x.obj
            ]
            for kinds in msc.sync_kinds
        ]
        k = len(msc.sync_kinds)

        def extend(i: int, prev: Op) -> bool:
            if i == k:
                return self._edge_holds(msc.edges[k], prev, y)
            for s in candidates[i]:
                if self._edge_holds(msc.edges[i], prev, s) and extend(i + 1, s):
                    return True
            return False

        return extend(0, x)

    def properly_synchronized(self, spec: ModelSpec, x: Op, y: Op) -> bool:
        """Paper §4.1 ps-relation. Assumes x, y conflict and x hb-or-unordered y.

        Checks X --ps--> Y for the given direction (caller orders by hb or
        tries both directions when unordered).
        """
        if x.type is OpType.READ:
            return self.hb(x, y)
        syncs = [o for o in self.ops if o.type is OpType.SYNC
                 and o.kind in spec.sync_ops]
        return any(self.msc_between(m, x, y, syncs) for m in spec.mscs)

    def storage_races(self, spec: ModelSpec) -> List[Tuple[Op, Op]]:
        """All conflicting pairs not properly synchronized in either order."""
        races: List[Tuple[Op, Op]] = []
        data = [o for o in self.ops if o.is_data]
        for i, x in enumerate(data):
            for y in data[i + 1:]:
                if not x.conflicts(y):
                    continue
                if x.pid == y.pid:
                    # Intra-process conflicts are ordered by program order
                    # (sequential process semantics) — standard DRF
                    # treatment.  The paper's MSC rule is stated for the
                    # inter-process case (all its examples are cross-
                    # process); see DESIGN.md §Assumption-log.
                    continue
                if self.hb(x, y):
                    ok = self.properly_synchronized(spec, x, y)
                elif self.hb(y, x):
                    ok = self.properly_synchronized(spec, y, x)
                else:
                    # Unordered conflicting ops: a race unless some MSC
                    # bridges them in one of the two directions (possible
                    # only through hb edges via syncs, which unordered data
                    # ops cannot have) — conservatively check both.
                    ok = (
                        self.properly_synchronized(spec, x, y)
                        or self.properly_synchronized(spec, y, x)
                    )
                if not ok:
                    races.append((x, y))
        return races

    def is_properly_synchronized_program(self, spec: ModelSpec) -> bool:
        return not self.storage_races(spec)

"""Vector-clock happens-before engine (FastTrack-style) for executions.

Replaces :meth:`repro_torch.core.model.Execution._build_hb`'s O(n²)
reachability sets with per-process vector clocks: one linear pass
assigns every op a *snapshot* ``{pid: seq}`` ("every op of ``pid`` with
program-order index ≤ ``seq`` happens before me"), after which
``hb(a, b)`` is a dict lookup.  The module is dependency-free and
duck-typed — any op with ``op_id`` / ``pid`` / ``seq`` attributes works —
so :mod:`repro_torch.core.model` can lazy-import it without a layering cycle.

Key properties:

* **Snapshot sharing.**  An op with no incoming so edge reuses its
  po-predecessor's snapshot dict; a join that is dominated by its
  largest input returns that input unchanged.  A hub-encoded barrier
  over P processes therefore costs O(P) total — all P post-barrier
  snapshots alias the hub's single release dict — where pairwise
  barrier edges plus closure sets would cost O(P²).
* **Incremental contract** (the `Execution` cache-invalidation fix).
  Appending ops never invalidates anything: the index lazily extends to
  the current watermark at the next query.  ``add_so(a, b)`` with ``b``
  not yet indexed is free; an edge into the already-indexed prefix
  re-derives only the suffix from ``b`` onward.  Only a *backward* edge
  in creation order (``a.op_id > b.op_id`` — impossible through
  `TracedRun`, possible by hand) demotes the index to full topo-order
  rebuilds, which is also where cycles in po ∪ so are detected
  (``ValueError``, same message as the closure builder).
  ``stats()`` exposes the pass counters so tests can pin the contract.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

#: Shared empty snapshot for ops with no happens-before predecessors.
#: Snapshots are immutable by convention — never mutate a stored dict.
_EMPTY: Dict[int, int] = {}


def _join(parts: List[Dict[int, int]]) -> Dict[int, int]:
    """Pointwise max of snapshot dicts, aliasing a dominating input."""
    if len(parts) == 1:
        return parts[0]
    best = parts[0]
    for d in parts[1:]:
        if len(d) > len(best):
            best = d
    for d in parts:
        if d is not best and any(best.get(k, -1) < v for k, v in d.items()):
            break
    else:
        return best
    out = dict(best)
    for d in parts:
        if d is best:
            continue
        for k, v in d.items():
            if out.get(k, -1) < v:
                out[k] = v
    return out


class VectorClockIndex:
    """Happens-before oracle over (ops, so_edges), kept live by reference.

    ``ops`` must satisfy ``ops[i].op_id == i`` (creation order; what
    :class:`~repro_torch.core.model.Execution` guarantees) and per-process
    ``seq`` must increase with creation order.  ``so_edges`` is a list
    of ``(a.op_id, b.op_id)`` pairs; both lists may keep growing after
    construction — queries re-sync lazily.
    """

    def __init__(self, ops: Sequence, so_edges: List[Tuple[int, int]]) -> None:
        self.ops = ops
        self.so_edges = so_edges
        #: snapshot[i][p] = s  ⇒  every op of pid p with seq ≤ s is hb ops[i].
        #: The op's own pid is implicit (handled via seq comparison).
        self._snap: List[Dict[int, int]] = []
        self._in: Dict[int, List[int]] = {}      # target op_id -> source ids
        self._release: Dict[int, Dict[int, int]] = {}
        self._prev_po: List[int] = []            # op_id -> same-pid predecessor
        self._last_of_pid: Dict[int, int] = {}
        self._edges_done = 0
        self._topo_mode = False   # a backward edge was seen: Kahn rebuilds
        # ---- contract counters (see stats()) ----
        self._ops_processed = 0
        self._full_builds = 0

    # ------------------------------------------------------------- queries
    def hb(self, a, b) -> bool:
        """Does ``a`` happen before ``b`` under po ∪ so (transitively)?"""
        if a.pid == b.pid:
            return a.seq < b.seq
        self._sync()
        return self._snap[b.op_id].get(a.pid, -1) >= a.seq

    def snapshot(self, op) -> Dict[int, int]:
        """The op's hb frontier ``{pid: max seq hb op}`` (own pid omitted)."""
        self._sync()
        return self._snap[op.op_id]

    def stats(self) -> Dict[str, int]:
        """Counters pinning the incremental contract in tests."""
        return {
            "ops_indexed": len(self._snap),
            "ops_processed": self._ops_processed,
            "full_builds": self._full_builds,
        }

    # ------------------------------------------------------------- indexing
    def _sync(self) -> None:
        edges = self.so_edges
        if self._edges_done < len(edges):
            lo: Optional[int] = None
            for a_id, b_id in edges[self._edges_done:]:
                if a_id >= b_id:
                    self._topo_mode = True
                self._in.setdefault(b_id, []).append(a_id)
                if b_id < len(self._snap):
                    lo = b_id if lo is None else min(lo, b_id)
            self._edges_done = len(edges)
            if self._topo_mode:
                self._snap = []
                self._release.clear()
            elif lo is not None:
                # Forward edge into the indexed prefix: re-derive only the
                # suffix.  Snapshots below ``lo`` cannot depend on it.
                del self._snap[lo:]
                for k in [k for k in self._release if k >= lo]:
                    del self._release[k]
        n = len(self.ops)
        while len(self._prev_po) < n:
            i = len(self._prev_po)
            pid = self.ops[i].pid
            self._prev_po.append(self._last_of_pid.get(pid, -1))
            self._last_of_pid[pid] = i
        if len(self._snap) == n:
            return
        if self._topo_mode:
            self._rebuild_topo()
        else:
            start = len(self._snap)
            for i in range(start, n):
                self._snap.append(self._compute(i))
                self._ops_processed += 1

    def _compute(self, i: int) -> Dict[int, int]:
        prev = self._prev_po[i]
        base = self._snap[prev] if prev >= 0 else None
        srcs = self._in.get(i)
        if not srcs:
            return base if base is not None else _EMPTY
        parts = [] if base is None else [base]
        for a_id in srcs:
            parts.append(self._release_of(a_id))
        return _join(parts)

    def _release_of(self, a_id: int) -> Dict[int, int]:
        r = self._release.get(a_id)
        if r is None:
            a = self.ops[a_id]
            s = self._snap[a_id]
            if s.get(a.pid, -1) >= a.seq:
                r = s
            else:
                r = dict(s)
                r[a.pid] = a.seq
            self._release[a_id] = r
        return r

    def _rebuild_topo(self) -> None:
        """Full Kahn-order rebuild; the only place cycles can hide.

        A cycle in po ∪ so requires an so edge that points backward in
        creation order (po and forward edges follow creation order), so
        the incremental path never needs this check.
        """
        n = len(self.ops)
        succ: List[List[int]] = [[] for _ in range(n)]
        indeg = [0] * n
        for i in range(n):
            p = self._prev_po[i]
            if p >= 0:
                succ[p].append(i)
                indeg[i] += 1
        for b_id, srcs in self._in.items():
            for a_id in srcs:
                succ[a_id].append(b_id)
                indeg[b_id] += 1
        order = [i for i in range(n) if indeg[i] == 0]
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
        self._release.clear()
        self._snap = [_EMPTY] * n
        for i in order:
            self._snap[i] = self._compute(i)
            self._ops_processed += 1
        self._full_builds += 1

"""Lift a real BaseFS run into the paper's formal :class:`Execution`.

:class:`ExecutionTracer` wraps any consistency layer
(:class:`~repro_torch.core.consistency._LayeredFS`) in a transparent
:class:`TracingLayer` proxy and mirrors the run into an
:class:`~repro_torch.core.model.Execution`:

* ``write``/``read`` → data ops over ``[pos, pos + n)`` of the file;
* every layer sync method → the formal sync op its class declares in
  ``sync_op_kinds`` (the Table-4 fence class — ``commit``,
  ``session_close``, ``file_sync``, ...);
* the workload's global phase barriers (``ledger.mark_phase``) → a
  hub-encoded barrier over every process seen so far: enter_i → hub →
  leave_i, O(P) so edges; a process whose first op appears *after* a
  barrier (readers open in the read phase) gets a join edge from the
  latest hub, so the phase ordering it physically observed is in hb;
* consumer-side ``Event.deps`` edges (a query blocking on producers'
  in-flight attach flushes, recorded by the RPC plane) → so edges from
  the producer's last op *before* the depended-on flush to the
  consumer's current op.  Producer attribution is exact (bisect on the
  ledger position at which each op was recorded); the consumer side
  binds to the client's most recent formal op, which is the issuing op
  itself on the unbatched path and a po-later op of the same process
  under batching — an under-approximation of hb, i.e. conservative for
  race detection.

The proxy changes nothing about the run itself: it delegates every call
and only observes.  ``tracer.exe`` is the lifted execution.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core import ops as opstream
from repro_torch.core.model import Execution, Op

#: Barrier hubs get dedicated negative pids, outside any real client id.
_HUB_PID_BASE = -1_000_000


class ExecutionTracer:
    """Builds the formal execution for one traced run."""

    def __init__(self, include_deps: bool = True) -> None:
        self.exe = Execution()
        self.include_deps = include_deps
        self.barriers = 0
        self.deps_edges = 0
        self._last_hub: Optional[Op] = None
        self._seen: Set[int] = set()
        self._ledger = None
        self._scanned = 0
        self._edge_set: Set[Tuple[int, int]] = set()
        # Per client: ledger positions + ops, in record order, for exact
        # dep-seq → producer-op attribution (parallel lists, bisectable).
        self._op_pos: Dict[int, List[int]] = {}
        self._op_log: Dict[int, List[Op]] = {}

    def attach(self, layer) -> "TracingLayer":
        """Wrap ``layer``; hooks the ledger's barrier callback."""
        ledger = layer.fs.ledger
        if self._ledger is None:
            self._ledger = ledger
            ledger.on_barrier.append(self._phase_barrier)
        elif self._ledger is not ledger:
            raise ValueError("one ExecutionTracer traces one BaseFS")
        return TracingLayer(layer, self)

    # ------------------------------------------------------------ recording
    def _log(self, pid: int, op: Op) -> None:
        self._op_pos.setdefault(pid, []).append(self._ledger.n_events)
        self._op_log.setdefault(pid, []).append(op)

    def touch(self, pid: int) -> None:
        """First sighting of a process: join it to the latest barrier."""
        if pid in self._seen:
            return
        self._seen.add(pid)
        if self._last_hub is not None:
            join = self.exe.sync(pid, "", "barrier_join")
            self.exe.add_so(self._last_hub, join)
            self._log(pid, join)

    def data(self, pid: int, path: str, write: bool, start: int,
             end: int) -> Op:
        self.touch(pid)
        op = (self.exe.write if write else self.exe.read)(
            pid, path, start, end)
        self._log(pid, op)
        self._scan_deps()
        return op

    def sync(self, pid: int, path: str, kind: str) -> Op:
        self.touch(pid)
        op = self.exe.sync(pid, path, kind)
        self._log(pid, op)
        self._scan_deps()
        return op

    # ------------------------------------------------------------- barriers
    def _phase_barrier(self) -> None:
        """ledger.mark_phase → hub-encoded barrier over all seen pids."""
        hub_pid = _HUB_PID_BASE - self.barriers
        self.barriers += 1
        enters = [self.exe.sync(pid, "", "barrier_enter")
                  for pid in sorted(self._seen)]
        hub = self.exe.sync(hub_pid, "", "barrier_hub")
        for e in enters:
            self.exe.add_so(e, hub)
            self._log(e.pid, e)
        for e in enters:
            lv = self.exe.sync(e.pid, "", "barrier_leave")
            self.exe.add_so(hub, lv)
            self._log(e.pid, lv)
        self._last_hub = hub

    # ------------------------------------------------------------ deps → so
    def _scan_deps(self) -> None:
        if not self.include_deps or self._ledger is None:
            return
        events = self._ledger.events
        for i in range(self._scanned, len(events)):
            ev = events[i]
            if not ev.deps:
                continue
            tgt_log = self._op_log.get(ev.client)
            if not tgt_log:
                continue
            tgt = tgt_log[-1]
            for d in ev.deps:
                producer = events[d].client
                pos = self._op_pos.get(producer)
                if not pos:
                    continue
                j = bisect_right(pos, d)
                if j == 0:
                    continue
                src = self._op_log[producer][j - 1]
                key = (src.op_id, tgt.op_id)
                if (src.pid == tgt.pid or src.op_id >= tgt.op_id
                        or key in self._edge_set):
                    continue
                self.exe.add_so(src, tgt)
                self._edge_set.add(key)
                self.deps_edges += 1
        self._scanned = len(events)


class TracingLayer:
    """Transparent proxy over a consistency layer that feeds the tracer.

    Exposes the full layer API (including ``fs``, ``name``,
    ``sync_op_kinds``) so workload drivers can use it drop-in.
    """

    def __init__(self, inner, tracer: ExecutionTracer) -> None:
        self.inner = inner
        self.tracer = tracer
        self.fs = inner.fs
        self.name = inner.name
        self.sync_points = inner.sync_points
        self.consumer_edges = inner.consumer_edges
        self.sync_op_kinds = inner.sync_op_kinds

    # ---- lifecycle -------------------------------------------------------
    def open(self, client_id, path, node=None, tier="ssd"):
        fh = self.inner.open(client_id, path, node, tier=tier)
        self.tracer.touch(client_id)
        return fh

    def file_open(self, client_id, path, node=None, tier="ssd"):
        fh = self.inner.file_open(client_id, path, node, tier=tier)
        self.tracer.sync(client_id, path, self.sync_op_kinds["file_open"])
        return fh

    def close(self, fh):
        return self.inner.close(fh)

    def file_close(self, fh):
        self.tracer.sync(fh.client.id, fh.path,
                         self.sync_op_kinds["file_close"])
        return self.inner.file_close(fh)

    def seek(self, fh, offset, *a, **kw):
        return self.inner.seek(fh, offset, *a, **kw)

    def tell(self, fh):
        return self.inner.tell(fh)

    def stat_size(self, fh):
        return self.inner.stat_size(fh)

    # ---- data ops --------------------------------------------------------
    def write(self, fh, data):
        pos = self.fs.bfs_tell(fh.client, fh.bfs_handle)
        n = self.inner.write(fh, data)
        self.tracer.data(fh.client.id, fh.path, True, pos, pos + n)
        return n

    def read(self, fh, size):
        pos = self.fs.bfs_tell(fh.client, fh.bfs_handle)
        data = self.inner.read(fh, size)
        self.tracer.data(fh.client.id, fh.path, False, pos, pos + size)
        return data

    # ---- sync ops (Table-4 fence classes) --------------------------------
    def _lost_before(self, fh) -> int:
        """Pending-loss count for ``fh``'s client under a lossy fault plane.

        A *lossy* failover (``FaultSchedule(lossy=True)``) silently drops
        in-flight attach batches instead of replaying them, so the
        publishing sync op the application believes it performed never
        reached stable metadata.  The tracer must not record a sync edge
        the storage system did not actually provide — that honesty is what
        lets the race checker witness the resulting data race.
        """
        faults = getattr(self.fs, "faults", None)
        if faults is None or not faults.schedule.lossy:
            return -1
        return faults.lost_count(fh.client.id)

    def _sync_unless_lost(self, fh, before: int, kind) -> None:
        faults = getattr(self.fs, "faults", None)
        if before >= 0 and faults.lost_count(fh.client.id) > before:
            return  # publish was dropped by a lossy failover: no sync edge
        self.tracer.sync(fh.client.id, fh.path, kind)

    def commit(self, fh):
        before = self._lost_before(fh)
        rc = self.inner.commit(fh)
        self._sync_unless_lost(fh, before, self.sync_op_kinds["commit"])
        return rc

    def session_open(self, fh):
        rc = self.inner.session_open(fh)
        self.tracer.sync(fh.client.id, fh.path,
                         self.sync_op_kinds["session_open"])
        return rc

    def session_close(self, fh):
        before = self._lost_before(fh)
        rc = self.inner.session_close(fh)
        self._sync_unless_lost(fh, before,
                               self.sync_op_kinds["session_close"])
        return rc

    def file_sync(self, fh):
        before = self._lost_before(fh)
        rc = self.inner.file_sync(fh)
        self._sync_unless_lost(fh, before,
                               self.sync_op_kinds["file_sync"])
        return rc

    # ---- bulk submission -------------------------------------------------
    def run_ops(self, program, handles, payload_fn=None, expect_fn=None):
        """Interpret a compiled op program op-by-op THROUGH the proxy.

        Tracing needs to observe every operation individually (and the
        dep scan reads the object event view), so a traced run takes
        the scalar reference path — same calls, same ledger, every
        formal op recorded — never the bulk kernels.  This is one of
        the "object path required" cases in ``docs/REPLAY.md``.
        """
        verified = 0
        ops_col, cl_col = program.op, program.client
        off_col, sz_col = program.offset, program.size
        for i in range(len(ops_col)):
            o = ops_col[i]
            fh = handles[cl_col[i]]
            if o == opstream.OP_WRITE:
                if payload_fn is None:
                    raise ValueError("op program contains writes but no "
                                     "payload_fn was given")
                off = off_col[i]
                self.seek(fh, off)
                self.write(fh, payload_fn(off, sz_col[i]))
            elif o == opstream.OP_READ:
                off = off_col[i]
                self.seek(fh, off)
                data = self.read(fh, sz_col[i])
                if expect_fn is not None:
                    if data != expect_fn(off, sz_col[i]):
                        raise AssertionError(
                            f"read mismatch at offset {off}")
                    verified += 1
            elif o == opstream.OP_COMMIT:
                self.commit(fh)
            elif o == opstream.OP_SESSION_OPEN:
                self.session_open(fh)
            elif o == opstream.OP_SESSION_CLOSE:
                self.session_close(fh)
            elif o == opstream.OP_FILE_SYNC:
                self.file_sync(fh)
            else:
                raise ValueError(f"unknown opcode {o}")
        return verified

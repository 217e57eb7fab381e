"""Race checking + SCNF verification for real BaseFS runs (§4 applied to §5).

:class:`TracedRun` drives any consistency layer from
:mod:`repro_torch.core.consistency` while recording the paper's formal execution
(data ops, sync ops, so edges from barriers / message pairs).  It can then

* detect **storage races** under any :class:`~repro_torch.core.model.ModelSpec`
  (is the traced program *properly synchronized* for that model?), and
* verify the **SCNF guarantee**: every read returned the value written by
  the hb-latest write (i.e., the run is sequentially consistent), which the
  paper promises for race-free programs.

Together these make the paper's central theorem executable: a program found
race-free under model M, when run on the M-layer, must pass the SC oracle.
Property tests in ``tests/test_checker.py`` exercise exactly this.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.basefs import SEEK_SET
from repro_torch.core.consistency import (
    CommitFS, FileHandle, MPIIOFS, SessionFS, _LayeredFS)
from repro_torch.core.model import Execution, ModelSpec, Op, OpType

# Layer API call -> formal sync-op kind (paper Table 4 naming).
_SYNC_KINDS = {
    "commit": "commit",
    "session_open": "session_open",
    "session_close": "session_close",
    "file_open": "file_open",
    "file_close": "file_close",
    "file_sync": "file_sync",
}


@dataclass
class _ReadRecord:
    op: Op
    actual: bytes  # lazy Payload in extent mode; compares/indexes like bytes


class TracedRun:
    """Wraps a consistency layer; mirrors every call into an Execution."""

    def __init__(self, layer: _LayeredFS) -> None:
        self.layer = layer
        self.exe = Execution()
        self.reads: List[_ReadRecord] = []
        self.write_data: Dict[int, bytes] = {}  # op_id -> payload
        self.initial: Dict[str, bytes] = {}      # preloaded PFS content
        self._barriers = 0

    # ------------------------------------------------------------- lifecycle
    def preload_pfs(self, path: str, data: bytes) -> None:
        """Pre-existing file content on the underlying PFS."""
        self.layer.fs.pfs.write(-1, path, 0, data)
        self.initial[path] = data

    def open(self, pid: int, path: str, node: Optional[int] = None
             ) -> FileHandle:
        if isinstance(self.layer, MPIIOFS):
            fh = self.layer.file_open(pid, path, node)
            self.exe.sync(pid, path, "file_open")
            return fh
        return self.layer.open(pid, path, node)

    def close(self, pid: int, fh: FileHandle) -> None:
        if isinstance(self.layer, MPIIOFS):
            self.exe.sync(pid, fh.path, "file_close")
            self.layer.file_close(fh)
            return
        self.layer.close(fh)

    # ------------------------------------------------------------- data ops
    def write_at(self, pid: int, fh: FileHandle, offset: int,
                 data: bytes) -> Op:
        self.layer.seek(fh, offset, SEEK_SET)
        self.layer.write(fh, data)
        op = self.exe.write(pid, fh.path, offset, offset + len(data))
        self.write_data[op.op_id] = data
        return op

    def read_at(self, pid: int, fh: FileHandle, offset: int, size: int) -> Op:
        self.layer.seek(fh, offset, SEEK_SET)
        actual = self.layer.read(fh, size)
        op = self.exe.read(pid, fh.path, offset, offset + size)
        self.reads.append(_ReadRecord(op, actual))
        return op

    # ------------------------------------------------------------- sync ops
    def commit(self, pid: int, fh: FileHandle) -> Op:
        assert isinstance(self.layer, CommitFS)
        self.layer.commit(fh)
        return self.exe.sync(pid, fh.path, "commit")

    def session_open(self, pid: int, fh: FileHandle) -> Op:
        assert isinstance(self.layer, SessionFS)
        self.layer.session_open(fh)
        return self.exe.sync(pid, fh.path, "session_open")

    def session_close(self, pid: int, fh: FileHandle) -> Op:
        assert isinstance(self.layer, SessionFS)
        self.layer.session_close(fh)
        return self.exe.sync(pid, fh.path, "session_close")

    def file_sync(self, pid: int, fh: FileHandle) -> Op:
        assert isinstance(self.layer, MPIIOFS)
        self.layer.file_sync(fh)
        return self.exe.sync(pid, fh.path, "file_sync")

    # --------------------------------------------------- program-level sync
    #: Barrier hubs live on their own process ids, far outside any real
    #: pid a test program would use.
    _HUB_PID_BASE = -1_000_000

    def barrier(self, pids: Sequence[int]) -> List[Op]:
        """MPI_Barrier among ``pids``.

        Hub-encoded: enter_i --so--> hub --so--> leave_i, with the hub a
        single sync op on a dedicated process — everything po-before any
        enter happens-before everything po-after any leave, exactly as
        with pairwise enter_i -> leave_j edges, but with O(P) edges
        instead of O(P²) (and one shared vector-clock snapshot for all
        the leaves; see :mod:`repro_torch.analysis.vectorclock`).  po ∪ so
        stays acyclic: every edge points forward in creation order.
        """
        hub_pid = self._HUB_PID_BASE - self._barriers
        self._barriers += 1
        enters = [self.exe.sync(pid, "", "barrier_enter") for pid in pids]
        hub = self.exe.sync(hub_pid, "", "barrier_hub")
        for e in enters:
            self.exe.add_so(e, hub)
        leaves = []
        for pid in pids:
            lv = self.exe.sync(pid, "", "barrier_leave")
            self.exe.add_so(hub, lv)
            leaves.append(lv)
        return leaves

    def send_recv(self, src: int, dst: int) -> Tuple[Op, Op]:
        """MPI_Send(src) + MPI_Recv(dst): one so edge."""
        s = self.exe.sync(src, "", "send")
        r = self.exe.sync(dst, "", "recv")
        self.exe.add_so(s, r)
        return s, r

    # ------------------------------------------------------------- checking
    def storage_races(self, spec: ModelSpec) -> List[Tuple[Op, Op]]:
        return self.exe.storage_races(spec)

    def expected_read(self, rec: _ReadRecord) -> Optional[bytes]:
        """hb-latest write per byte; None if some byte is racy/ambiguous."""
        r = rec.op
        n = r.end - r.start
        init = self.initial.get(r.obj, b"")
        out = bytearray(n)
        for i in range(n):
            p = r.start + i
            best: Optional[Op] = None
            for op in self.exe.ops:
                if (
                    op.type is OpType.WRITE
                    and op.obj == r.obj
                    and op.start <= p < op.end
                    and self.exe.hb(op, r)
                ):
                    if best is None or self.exe.hb(best, op):
                        best = op
                    elif not self.exe.hb(op, best):
                        return None  # two unordered hb-prior writes: racy
            if best is None:
                out[i] = init[p] if p < len(init) else 0
            else:
                out[i] = self.write_data[best.op_id][p - best.start]
        return bytes(out)

    def check_sc(self) -> List[str]:
        """SC oracle over all reads; returns human-readable violations."""
        bad: List[str] = []
        for rec in self.reads:
            exp = self.expected_read(rec)
            if exp is None:
                continue  # ambiguous under hb: racy program, skip
            if rec.actual != exp:
                bad.append(
                    f"read p{rec.op.pid} [{rec.op.start},{rec.op.end}) of "
                    f"{rec.op.obj}: got {rec.actual[:16]!r}... "
                    f"expected {exp[:16]!r}..."
                )
        return bad

    def verify_scnf(self, spec: ModelSpec) -> Tuple[bool, List, List[str]]:
        """(program_race_free, races, sc_violations).

        The SCNF contract: race_free implies sc_violations == [].
        """
        races = self.storage_races(spec)
        violations = self.check_sc()
        return (not races, races, violations)

"""Consistency layers over BaseFS (paper §5.2, Table 6).

Each layer exposes the paper's API and differs ONLY in where it places the
``attach`` / ``query`` primitives:

=============  =====================================================
PosixFS        write -> bfs_write; bfs_attach       read -> bfs_query; bfs_read
CommitFS       write -> bfs_write                   read -> bfs_query; bfs_read
               commit -> bfs_attach_file
SessionFS      write -> bfs_write                   read -> bfs_read (cached owners)
               session_open -> bfs_query_file       session_close -> bfs_attach_file
MPIIOFS        MPI-IO third-level consistency: sync/close flush-attach, sync/open
               query; sequential consistency per single file handle.
=============  =====================================================

Reads that hit a range with *no* attached owner fall through to the
underlying PFS (latest flushed data), per §5.1.2.  Reads covering multiple
owners are split along the owner intervals returned by the query.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core import ops as opstream
from repro_torch.core.basefs import SEEK_SET, BaseFS, BFSClient
from repro_torch.core.extents import Payload, concat
from repro_torch.core.intervals import Interval, OwnerIntervalMap
from repro_torch.core.routing import StaticRouter


@dataclass
class FileHandle:
    """Opaque per-layer handle wrapping a BaseFS handle."""

    client: BFSClient
    bfs_handle: int
    path: str
    # SessionFS: owner map snapshot taken at session_open.
    owner_cache: Optional[OwnerIntervalMap] = None
    in_session: bool = False


class _LayeredFS:
    """Shared mechanics: owner-resolved reads, positioning, stat.

    Every layer declares its *fence points* — the operations at which the
    client's RPC send queue must be flushed because the consistency model
    makes metadata visibility observable there.  The explicit fences are:
    ``CommitFS.commit``, ``SessionFS.session_close``,
    ``MPIIOFS.file_sync`` / ``file_close``, and file ``close`` in every
    layer (a closing client drains its send queue).  PosixFS has no
    semantic sync point; its batches close only on the send queue's own
    triggers (size cap, dependency, switch, barriers) — which is the
    relaxation the fig3 posix-with-batching column quantifies.

    Under an ack window (``BaseFS(ack_window=K)``) these same fence
    points are also where the model DRAINS unacked fire-and-forget
    attach flushes: a commit/session_close/file_sync/close does not
    return until every outstanding flush is acknowledged, so no layer
    can report a sync complete while its metadata is still in flight.
    The fence routes through :meth:`repro_torch.core.basefs.RPCBatcher.fence`,
    which records a zero-cost sync marker when the queue is empty but
    flushes are unacked — the DES stalls the chain there.  Between
    fences, a dependent read's query (and any blocking RPC) is the other
    sync point; everything else streams, with ``Event.deps`` edges as
    the cross-client correctness backstop.
    """

    name = "base"
    #: Layer operations that fence the RPC send queue (documentation +
    #: introspection; the methods below call ``fs.rpc_fence`` themselves).
    sync_points: Tuple[str, ...] = ("close",)
    #: Layer operations that CONSUME other clients' metadata: their
    #: queries dep-flush every in-flight attach batch on the file and
    #: carry ``Event.deps`` edges on those flushes, so the DES blocks
    #: them at the shard master until the producers' flushes are
    #: serviced (the cross-client visibility edge of §V — where the
    #: session-vs-commit gap is priced).  The edges are emitted by
    #: ``GlobalServer.query``/``query_file``/``stat_eof``; this
    #: attribute documents which layer operations reach them.
    consumer_edges: Tuple[str, ...] = ("stat_size",)
    #: Formal fence class of every layer sync method: layer API call →
    #: Table-4 sync-op kind.  This is what the race analyzer records
    #: when it lifts a run into an :class:`~repro_torch.core.model.Execution`
    #: (see :mod:`repro.analysis.trace`), and the DES-invariant lint
    #: (:mod:`repro.analysis.lint`) requires every registered layer to
    #: declare it explicitly — an empty dict is PosixFS asserting
    #: "S = ∅", not an omission.
    sync_op_kinds: Dict[str, str] = {}

    def __init__(self, fs: Optional[BaseFS] = None) -> None:
        self.fs = fs or BaseFS()

    # ---- lifecycle ----
    def open(self, client_id: int, path: str, node: Optional[int] = None,
             tier: str = "ssd") -> FileHandle:
        c = self.fs.client(client_id, node, tier=tier)
        h = self.fs.bfs_open(c, path)
        return FileHandle(c, h, path)

    def close(self, fh: FileHandle) -> int:
        # Closing a file drains the client's send queue: a real client's
        # outstanding metadata messages are flushed before close returns.
        self.fs.rpc_fence(fh.client)
        return self.fs.bfs_close(fh.client, fh.bfs_handle)

    def seek(self, fh: FileHandle, offset: int, whence: int = SEEK_SET) -> int:
        return self.fs.bfs_seek(fh.client, fh.bfs_handle, offset, whence)

    def tell(self, fh: FileHandle) -> int:
        return self.fs.bfs_tell(fh.client, fh.bfs_handle)

    def stat_size(self, fh: FileHandle) -> int:
        return self.fs.bfs_stat_size(fh.client, fh.bfs_handle)

    # ---- owner-resolved read used by every layer ----
    def _read_resolved(self, fh: FileHandle, size: int,
                       owners: List[Interval]) -> Payload:
        """Read [pos, pos+size) splitting along the owner intervals.

        ``owners`` are the attach intervals overlapping the range (possibly
        empty).  Unowned gaps are served by the underlying PFS.  A reader
        that owns a sub-range serves it from its own buffer.  Returns a
        lazy :class:`~repro_torch.core.extents.Payload` (sub-reads re-coalesce,
        so a pattern-written block compares symbolically).
        """
        fs, c, h = self.fs, fh.client, fh.bfs_handle
        start = fs.bfs_tell(c, h)
        end = start + size
        parts: List[Payload] = []
        # Segment resolution (owner split + local-write preference,
        # Table 5) is shared with the bulk read kernel.
        for s, e, owner in fs.bfs_resolve_segs(c, h, start, end, owners):
            fs.bfs_seek(c, h, s, SEEK_SET)
            parts.append(fs.bfs_read(c, h, e - s, owner))
        fs.bfs_seek(c, h, end, SEEK_SET)
        return concat(parts)

    # ---- bulk submission API (op programs) ----
    def run_ops(self, program: "opstream.OpProgram",
                handles: Dict[int, FileHandle],
                payload_fn=None, expect_fn=None) -> int:
        """Execute a compiled op program (:mod:`repro_torch.core.ops`).

        This is the layer's bulk submission API — and the only legal
        entry into the BaseFS bulk kernels (lint rule ANA005).  Runs of
        WRITE/READ ops dispatch to the columnar kernels when the
        deployment qualifies; everything else — and every control op —
        executes through the layer's own scalar methods, so each sync
        point, fence, and ``sync_op_kinds`` hook runs at exactly the
        position the scalar loop would have run it.  The resulting
        ledger is bitwise-identical to the scalar op-by-op loop either
        way (the golden/hypothesis contract in ``docs/ARCHITECTURE.md``).

        ``handles`` maps the program's client ids to open
        :class:`FileHandle`\\ s.  ``payload_fn(offset, size)`` supplies
        write payloads (required when the program contains writes);
        ``expect_fn(offset, size)``, when given, verifies every read.
        Returns the number of reads verified.
        """
        fs = self.fs
        ops_col = program.op
        cl_col = program.client
        off_col = program.offset
        sz_col = program.size
        n = len(ops_col)
        batcher = fs.server.batcher
        enabled = batcher.enabled
        # Kernel eligibility.  The kernels append ledger rows directly,
        # skipping the pre_record hooks — legal only when the hook list
        # is exactly the batcher's activity hook AND it is provably a
        # no-op for the run: with the batcher disabled the hook never
        # fires, and with linger > 0 it ignores data events.  Zero
        # linger (flush-before-next-event semantics) and foreign hooks
        # force the scalar path.  Query-placement models additionally
        # need the static router (adaptive routing observes/migrates on
        # every RPC mid-run) and a disabled batcher on the read side
        # (dep flushes anchor to live queue state).
        cols_ok = fs.ledger.authoritative_rows() is not None
        hooks_ok = fs.ledger.pre_record == [batcher._on_client_activity]
        static = type(fs.server.router) is StaticRouter
        posix = self.name == "posix"
        qread = self.name in ("posix", "commit")
        write_fast = (cols_ok and hooks_ok
                      and (not enabled or batcher.linger > 0.0)
                      and (static or not posix))
        read_fast = (cols_ok and hooks_ok and not enabled
                     and (static or not qread))
        # Program cid -> (BFSClient, handle) / owner-cache maps for the
        # kernels, built once per submission on first use.
        hmap = None
        omap = None
        verified = 0
        i = 0
        while i < n:
            o = ops_col[i]
            if o == opstream.OP_WRITE:
                j = i + 1
                while j < n and ops_col[j] == opstream.OP_WRITE:
                    j += 1
                if payload_fn is None:
                    raise ValueError("op program contains writes but no "
                                     "payload_fn was given")
                if write_fast:
                    if hmap is None:
                        hmap = {cid: (fh.client, fh.bfs_handle)
                                for cid, fh in handles.items()}
                    fs.bulk_write_run(hmap, cl_col, off_col, sz_col, i, j,
                                      payload_fn, attach=posix)
                else:
                    for k in range(i, j):
                        fh = handles[cl_col[k]]
                        off = off_col[k]
                        self.seek(fh, off)
                        self.write(fh, payload_fn(off, sz_col[k]))
                i = j
            elif o == opstream.OP_READ:
                j = i + 1
                while j < n and ops_col[j] == opstream.OP_READ:
                    j += 1
                if read_fast:
                    if hmap is None:
                        hmap = {cid: (fh.client, fh.bfs_handle)
                                for cid, fh in handles.items()}
                    if not qread and omap is None:
                        omap = {cid: fh.owner_cache
                                for cid, fh in handles.items()}
                    verified += fs.bulk_read_run(
                        hmap, cl_col, off_col, sz_col, i, j,
                        owner_maps=omap, expect_fn=expect_fn, query=qread)
                else:
                    for k in range(i, j):
                        fh = handles[cl_col[k]]
                        off = off_col[k]
                        self.seek(fh, off)
                        data = self.read(fh, sz_col[k])
                        if expect_fn is not None:
                            if data != expect_fn(off, sz_col[k]):
                                raise AssertionError(
                                    f"read mismatch at offset {off}")
                            verified += 1
                i = j
            else:
                fh = handles[cl_col[i]]
                if o == opstream.OP_COMMIT:
                    self.commit(fh)
                elif o == opstream.OP_SESSION_OPEN:
                    self.session_open(fh)
                elif o == opstream.OP_SESSION_CLOSE:
                    self.session_close(fh)
                elif o == opstream.OP_FILE_SYNC:
                    self.file_sync(fh)
                else:
                    raise ValueError(f"unknown opcode {o}")
                # Sync ops may swap a handle's owner_cache snapshot:
                # rebuild the kernels' owner-map view on the next run.
                omap = None
                i += 1
        return verified


class PosixFS(_LayeredFS):
    """POSIX consistency: attach on every write, query on every read.

    With RPC batching enabled (``BaseFS(batch=N)``) the per-write attaches
    of a streaming writer coalesce into multi-range RPCs — the headline
    win, since PosixFS otherwise pays one server round-trip per write.
    The layer has no semantic sync point, so only the send queue's own
    close triggers apply: size cap, a read consuming a query answer, a
    query on a file with pending attaches, type/file switch, and phase
    barriers.  Strict POSIX makes every attach immediately observable;
    the batched variant relaxes that by up to the coalescing window —
    measured honestly by the DES at flush time, and kept consistent with
    the content layer by the query-side dependency flush.
    """

    name = "posix"
    sync_points = ("close",)
    consumer_edges = ("read", "stat_size")  # query per read
    sync_op_kinds = {}  # S = ∅ (paper Table 4): hb alone synchronizes

    def write(self, fh: FileHandle, data: bytes) -> int:
        fs, c, h = self.fs, fh.client, fh.bfs_handle
        pos = fs.bfs_tell(c, h)
        n = fs.bfs_write(c, h, data)
        fs.bfs_attach(c, h, pos, len(data))
        return n

    def read(self, fh: FileHandle, size: int) -> Payload:
        fs, c, h = self.fs, fh.client, fh.bfs_handle
        pos = fs.bfs_tell(c, h)
        owners = fs.bfs_query(c, h, pos, size)
        return self._read_resolved(fh, size, owners)


class CommitFS(_LayeredFS):
    """Commit consistency: attach only at commit; query before every read."""

    name = "commit"
    sync_points = ("commit", "close")
    consumer_edges = ("read", "stat_size")  # query per read
    sync_op_kinds = {"commit": "commit"}

    def write(self, fh: FileHandle, data: bytes) -> int:
        return self.fs.bfs_write(fh.client, fh.bfs_handle, data)

    def commit(self, fh: FileHandle) -> int:
        """Make all this client's uncommitted writes to the file visible.

        A commit is a sync point: it flushes (fences) the client's RPC
        send queue so a batched attach cannot remain open across it.
        """
        rc = self.fs.bfs_attach_file(fh.client, fh.bfs_handle)
        self.fs.rpc_fence(fh.client)
        return rc

    def read(self, fh: FileHandle, size: int) -> Payload:
        fs, c, h = self.fs, fh.client, fh.bfs_handle
        pos = fs.bfs_tell(c, h)
        owners = fs.bfs_query(c, h, pos, size)
        return self._read_resolved(fh, size, owners)


class SessionFS(_LayeredFS):
    """Session (close-to-open) consistency.

    ``session_open`` performs ONE ``bfs_query_file`` and caches the owner
    map; reads within the session resolve owners from the cache with no
    server traffic.  ``session_close`` attaches all local writes.
    """

    name = "session"
    sync_points = ("session_close", "close")
    # One consumer edge per session: reads resolve owners from the
    # session_open snapshot, so only the opening query blocks on
    # in-flight writer flushes.
    consumer_edges = ("session_open", "stat_size")
    sync_op_kinds = {
        "session_open": "session_open",
        "session_close": "session_close",
    }

    def session_open(self, fh: FileHandle) -> None:
        owners = self.fs.bfs_query_file(fh.client, fh.bfs_handle)
        cache = OwnerIntervalMap()
        for iv in owners:
            cache.attach(iv.start, iv.end, iv.value)
        fh.owner_cache = cache
        fh.in_session = True

    def session_close(self, fh: FileHandle) -> int:
        rc = self.fs.bfs_attach_file(fh.client, fh.bfs_handle)
        self.fs.rpc_fence(fh.client)  # close-to-open boundary = sync point
        fh.in_session = False
        return rc

    def write(self, fh: FileHandle, data: bytes) -> int:
        return self.fs.bfs_write(fh.client, fh.bfs_handle, data)

    def read(self, fh: FileHandle, size: int) -> Payload:
        if fh.owner_cache is None:
            # Session never opened: only local writes / PFS are visible.
            owners: List[Interval] = []
        else:
            pos = self.fs.bfs_tell(fh.client, fh.bfs_handle)
            owners = fh.owner_cache.owners(pos, pos + size)
        return self._read_resolved(fh, size, owners)


class MPIIOFS(_LayeredFS):
    """MPI-IO consistency, third level (§2.3.3, §4.2.4).

    ``file_sync`` acts as BOTH a writer-side attach and a reader-side
    query (MPI_File_sync flushes the writer's data and retrieves the
    latest data for the reader).  ``file_open``/``file_close`` carry the
    session-like endpoints.  Within one handle, reads resolve against the
    snapshot retrieved by the last sync/open — mirroring that MPI-IO only
    guarantees visibility across the sync-barrier-sync construct.
    """

    name = "mpiio"
    sync_points = ("file_sync", "file_close", "close")
    consumer_edges = ("file_open", "file_sync", "stat_size")
    sync_op_kinds = {
        "file_open": "file_open",
        "file_close": "file_close",
        "file_sync": "file_sync",
    }

    def file_open(self, client_id: int, path: str,
                  node: Optional[int] = None,
                  tier: str = "ssd") -> FileHandle:
        fh = self.open(client_id, path, node, tier=tier)
        self._refresh(fh)
        return fh

    def _refresh(self, fh: FileHandle) -> None:
        owners = self.fs.bfs_query_file(fh.client, fh.bfs_handle)
        cache = OwnerIntervalMap()
        for iv in owners:
            cache.attach(iv.start, iv.end, iv.value)
        fh.owner_cache = cache

    def file_sync(self, fh: FileHandle) -> None:
        # Writer side: publish local writes; reader side: refresh snapshot.
        # MPI_File_sync is a full sync point: fence the RPC send queue.
        self.fs.bfs_attach_file(fh.client, fh.bfs_handle)
        self.fs.rpc_fence(fh.client)
        self._refresh(fh)

    def file_close(self, fh: FileHandle) -> int:
        self.fs.bfs_attach_file(fh.client, fh.bfs_handle)
        self.fs.rpc_fence(fh.client)
        return self.close(fh)

    def write(self, fh: FileHandle, data: bytes) -> int:
        return self.fs.bfs_write(fh.client, fh.bfs_handle, data)

    def read(self, fh: FileHandle, size: int) -> Payload:
        owners: List[Interval] = []
        if fh.owner_cache is not None:
            pos = self.fs.bfs_tell(fh.client, fh.bfs_handle)
            owners = fh.owner_cache.owners(pos, pos + size)
        return self._read_resolved(fh, size, owners)


LAYERS = {
    "posix": PosixFS,
    "commit": CommitFS,
    "session": SessionFS,
    "mpiio": MPIIOFS,
}


def make_fs(model: str, fs: Optional[BaseFS] = None) -> _LayeredFS:
    try:
        return LAYERS[model](fs)
    except KeyError:
        raise ValueError(
            f"unknown consistency model {model!r}; choose from {sorted(LAYERS)}"
        ) from None

"""BaseFS — the paper's base-layer burst-buffer PFS (§5.1, Table 5).

BaseFS provides *no* implicit consistency.  Each logical client buffers its
writes in a node-local burst buffer (here: an in-process extent log standing
in for the Intel 910 SSD); visibility between clients is established only by
explicit ``attach`` / ``query`` synchronization primitives handled by the
global metadata service — the paper's single server by default, hash-
partitioned over ``num_shards`` independent shards when configured.
Consistency layers (PosixFS/CommitFS/SessionFS/
MPIIOFS, see :mod:`repro_torch.core.consistency`) are built on these primitives.

Everything observable by the cost model is recorded in an :class:`EventLedger`:
per-client SSD bytes, client-to-client transfer bytes, underlying-PFS bytes,
and every server RPC with its type and payload size.  The discrete-event
cost model (:mod:`repro_torch.core.costmodel`) replays the ledger against hardware
constants to produce bandwidth numbers; :mod:`repro_torch.core.vecreplay` is its
bitwise-identical struct-of-arrays engine (``replay(engine="vector")``,
contract in ``docs/REPLAY.md``).

Data plane: burst buffers and PFS files store lazy *payload extents*
(:mod:`repro_torch.core.extents`) instead of real byte arrays — a write appends
an extent descriptor, a read returns (re-coalesced) slices, and the
deterministic-pattern benchmarks verify reads symbolically with zero byte
materialization, which is what lets the paper's full ~15 GB grids run in
container RAM.  Correctness stays testable end-to-end: any caller that
genuinely needs bytes materializes lazily (``bytes(payload)``), and
``BaseFS(materialize=True)`` retains the byte-moving fallback, producing
an event-for-event identical ledger by construction.
"""

from __future__ import annotations

import itertools
from bisect import bisect_right
from collections import Counter as _Counter
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple
from zlib import crc32

from repro_torch.core.extents import (ExtentFile, ExtentLog, Payload,  # noqa: F401
                                      ZeroExtent, as_payload, concat)
from repro_torch.core.intervals import BufferIntervalMap, Interval, OwnerIntervalMap
from repro_torch.core.routing import DEFAULT_STRIPE, StaticRouter, make_router
from repro_torch.core.routing import shard_of  # noqa: F401  (re-export, see below)

try:  # columnar read-run accelerator; the scalar kernel needs no numpy
    import numpy as _np
except Exception:  # pragma: no cover - numpy ships with the toolchain image
    _np = None


class BFSError(Exception):
    """Erroneous use of a BaseFS primitive (per Table 5 return conventions)."""


# --------------------------------------------------------------------------
# Event ledger — the measured substrate the cost model replays.
# --------------------------------------------------------------------------
class EventKind(Enum):
    SSD_WRITE = "ssd_write"          # client -> local burst buffer
    SSD_READ = "ssd_read"            # local burst buffer -> client
    NET_TRANSFER = "net"             # owner client -> reader client (RDMA)
    PFS_WRITE = "pfs_write"          # flush to underlying PFS (Lustre)
    PFS_READ = "pfs_read"            # read from underlying PFS
    RPC = "rpc"                      # client <-> global server message
    MEM_READ = "mem_read"            # served from local memory buffer (SCR)
    MEM_WRITE = "mem_write"
    MARKER = "marker"                # phase boundary / global barrier


@dataclass(frozen=True)
class Event:
    kind: EventKind
    client: int                      # issuing client (node id encoded by caller)
    nbytes: int = 0
    rpc_type: str = ""               # attach/detach/query/stat/migrate
    peer: int = -1                   # transfer peer (owner for NET_TRANSFER)
    seq: int = 0                     # global issue order
    rpc_ranges: int = 1              # range descriptors in an RPC payload
    shard: int = 0                   # metadata-server shard handling an RPC
    rpc_calls: int = 1               # client calls coalesced into this RPC
    flush: str = ""                  # send-queue close reason ("" = unqueued)
    linger: float = 0.0              # send-queue linger window (s; see DES)
    # Cross-client dependency edges: global seqs of producer events whose
    # server-side effect this RPC's service must observe (e.g. a query
    # blocks on the writer's dep-flushed attach batch at the shard
    # master).  Empty for unqueued traffic — the paper's default
    # deployment carries no edges and replays exactly as before.
    deps: Tuple[int, ...] = ()
    # Virtual-clock anchors for the time-driven DES batcher: the seq of
    # the SAME client's most recent ledger event when the send queue
    # opened (first member enqueued) and when the LAST member was
    # enqueued.  -1 = no prior event (the queue opened at phase start).
    opened_after: int = -1
    last_after: int = -1
    # For a flush forced by ANOTHER client (a consumer's dep-flush): the
    # forcing client's most recent ledger-event seq — the virtual-clock
    # floor of the forced close, since the producer's own chain position
    # says nothing about when the consumer asked.  -1 = self-forced.
    forced_after: int = -1
    # Per-member virtual-clock anchors of a flushed batch: one
    # ``(anchor_seq, nranges)`` pair per coalesced client call, in
    # enqueue order (``anchor_seq`` is the same-client ledger seq of the
    # most recent event when that member was enqueued; -1 = none).  The
    # DES uses these to RE-SPLIT the batch at linger-timer expiries that
    # fired before later members were issued — batch *membership* is
    # time-driven, not ledger-order-driven.  Empty for unqueued traffic.
    members: Tuple[Tuple[int, int], ...] = ()
    # Fault-plane stamps (:mod:`repro_torch.core.faults`): how many times this
    # wire message was dropped before succeeding (the DES prices each
    # attempt as timeout + exponential backoff and counts it in
    # ``rpc_msgs`` — retries are never free), and whether this message
    # tripped a shard-master failover (the DES prices the recovery
    # window at that shard).  Always 0 with ``faults=None``; only the
    # ledger itself and the batcher's recovery path may set these
    # (lint rule ANA004).
    retries: int = 0
    failover: int = 0


# Row layout of the ledger's columnar append representation: one tuple
# per event holding every Event field EXCEPT ``seq`` (derived: row i has
# seq ``_seq0 + i``), in Event field order.  Kept as flat row tuples —
# ~3x smaller than Event objects and transposable to columns in one
# ``zip(*rows)`` — so 100M-event ledgers never pay per-object overhead
# on the append path and ``vecreplay.lower()`` reads them natively.
#
# The ``kind`` cell stores ``EventKind.value`` (an interned str), NOT
# the enum member: every row field is then a GC-atomic immutable, the
# collector untracks the tuples on its first pass, and a million-row
# ledger adds nothing to later full-collection sweeps (enum members are
# ordinary tracked objects and would pin every row in the scan set —
# measured at ~45% of bulk execution time at the fig7_big scale).
_ROW_FIELDS = ("kind", "client", "nbytes", "rpc_type", "peer",
               "rpc_ranges", "shard", "rpc_calls", "flush", "linger",
               "deps", "opened_after", "last_after", "forced_after",
               "members", "retries", "failover")

# kind-cell encodings for the row builders, and the decode map back to
# the enum for Event materialization.
_SSD_W_V = EventKind.SSD_WRITE.value
_SSD_R_V = EventKind.SSD_READ.value
_NET_V = EventKind.NET_TRANSFER.value
_PFS_R_V = EventKind.PFS_READ.value
_RPC_V = EventKind.RPC.value
_MEM_W_V = EventKind.MEM_WRITE.value
_MEM_R_V = EventKind.MEM_READ.value
_KIND_OF = {k.value: k for k in EventKind}


# Shared default tail of a data-event row — every Event field after
# (kind, client, nbytes) at its default.  The bulk kernels append
# ``(kind, client, nbytes) + _DATA_TAIL`` for SSD/MEM/NET/PFS rows.
_DATA_TAIL = ("", -1, 1, 0, 1, "", 0.0, (), -1, -1, -1, (), 0, 0)


def _row_to_event(row: tuple, seq: int) -> Event:
    r = row
    return Event(_KIND_OF[r[0]], r[1], r[2], r[3], r[4], seq, r[5], r[6],
                 r[7], r[8], r[9], r[10], r[11], r[12], r[13], r[14],
                 r[15], r[16])


class EventLedger:
    """Append-only record of every I/O and RPC event in issue order.

    A batched RPC is recorded ONCE, at the position where the client's
    send queue flushes it (see :class:`RPCBatcher`) — never back-dated to
    the first coalesced call, so a coalesced member can never appear
    before interleaved data events it logically follows.  ``on_barrier``
    hooks let the batcher close open queues at phase boundaries;
    ``pre_record`` hooks let a zero-linger queue flush before any
    intervening event by the same client is appended.

    Storage is columnar (``_rows``: one 17-tuple per event, seq
    derived); ``.events`` is a LAZY materialization of the object view
    for diagnostics, the tracer, and the race checker.  Mutating the
    materialized list (tests do, to build unsupported ledgers) flips the
    ledger into legacy object-authoritative mode: the row store is
    abandoned and every consumer — including ``vecreplay.lower()`` —
    falls back to the object path.  Contract in ``docs/REPLAY.md``.
    """

    def __init__(self) -> None:
        self._rows: List[tuple] = []
        self._seq0 = 0               # seq of _rows[0]
        self._next_seq = 0           # seq the next appended row will get
        # Lazy object view: _evcache materializes _rows[:_mat_rows];
        # _cache_len remembers its length at the last sync so external
        # mutation (len change) is detectable; _legacy marks the object
        # list as authoritative after such a mutation.
        self._evcache: Optional[List[Event]] = None
        self._mat_rows = 0
        self._cache_len = 0
        self._legacy = False
        self.client_node: Dict[int, int] = {}  # client id -> node id
        self.on_barrier: List[Callable[[], None]] = []
        self.pre_record: List[Callable[[EventKind, int], None]] = []
        # Deployment ack window (``BaseFS(ack_window=K)``): the DES reads
        # it as the default for ``CostModel.replay(ack_window=)``.  0 =
        # every flushed batch blocks the issuing chain on its round trip.
        self.ack_window: int = 0
        # Per-client seq of the most recently appended event; the send
        # queues use it to stamp virtual-clock anchors on flushed batches.
        self.last_seq: Dict[int, int] = {}
        # Incremental aggregates maintained by record(): count()/
        # total_bytes() answer in O(1) instead of scanning the full
        # event list (which the benchmark drivers query per phase).
        self._count_by_type: Dict[Tuple[EventKind, str], int] = {}
        self._count_by_kind: Dict[EventKind, int] = {}
        self._bytes_by_kind: Dict[EventKind, int] = {}
        # Fault plane (:mod:`repro_torch.core.faults`): the run's FaultState,
        # attached by ``BaseFS(faults=...)``.  record() stamps every RPC
        # wire message through it; None (the default) is the fault-free
        # model and changes nothing.
        self.faults = None

    # ---- object view (lazy materialization) ----
    @property
    def events(self) -> List[Event]:
        """Materialized Event list — object view of the row store.

        The returned list is cached and extended incrementally; callers
        may mutate it (legacy tests do), which makes the object list
        authoritative and disables the columnar fast paths.
        """
        cache = self._evcache
        if cache is None:
            cache = self._evcache = []
        elif not self._legacy and len(cache) != self._cache_len:
            self._legacy = True
        if self._legacy:
            return cache
        rows, mat = self._rows, self._mat_rows
        if mat < len(rows):
            seq0 = self._seq0
            cache.extend(_row_to_event(rows[i], seq0 + i)
                         for i in range(mat, len(rows)))
            self._mat_rows = len(rows)
        self._cache_len = len(cache)
        return cache

    @property
    def n_events(self) -> int:
        """Event count without materializing the object view."""
        if self._legacy:
            return len(self._evcache)
        cache = self._evcache
        if cache is not None and len(cache) != self._cache_len:
            self._legacy = True
            return len(cache)
        return len(self._rows)

    @property
    def last_recorded_seq(self) -> int:
        """Seq of the most recently appended event (-1 if none ever)."""
        if self._legacy:
            cache = self._evcache
            return cache[-1].seq if cache else -1
        return self._next_seq - 1

    def authoritative_rows(self) -> Optional[List[tuple]]:
        """Row store, or None once the object view was mutated.

        The columnar consumers (bulk kernels, ``vecreplay.lower()``)
        gate on this: a mutated ``.events`` list means the rows no
        longer describe the ledger and the object path must be used.
        """
        cache = self._evcache
        if self._legacy or (cache is not None
                            and len(cache) != self._cache_len):
            self._legacy = True
            return None
        return self._rows

    def _cache_key(self) -> Tuple[int, int, int]:
        """Identity key for the vectorized-replay lowering cache."""
        rows = self.authoritative_rows()
        if rows is None:
            ev = self._evcache
            return (len(ev), len(self.client_node),
                    ev[-1].seq if ev else -1)
        return (len(rows), len(self.client_node),
                self._seq0 + len(rows) - 1 if rows else -1)

    def record(self, kind: EventKind, client: int, nbytes: int = 0,
               rpc_type: str = "", peer: int = -1, rpc_ranges: int = 1,
               shard: int = 0, rpc_calls: int = 1, flush: str = "",
               linger: float = 0.0, deps: Tuple[int, ...] = (),
               opened_after: int = -1, last_after: int = -1,
               forced_after: int = -1,
               members: Tuple[Tuple[int, int], ...] = (),
               retries: int = 0, failover: int = 0) -> None:
        for hook in self.pre_record:
            hook(kind, client)
        # Every RPC wire message passes through the fault plane at its
        # recording position: the stamp draw is counter-keyed off the
        # schedule seed, so the ledger is deterministic per seed.  The
        # client-side fence marker carries no wire message and is exempt.
        if (self.faults is not None and kind is EventKind.RPC
                and rpc_type != RPC_FENCE_MARKER):
            r, f = self.faults.on_rpc(rpc_type, shard)
            retries += r
            if f:
                failover = 1
        seq = self._next_seq
        self._next_seq = seq + 1
        row = (kind.value, client, nbytes, rpc_type, peer, rpc_ranges,
               shard, rpc_calls, flush, linger, deps, opened_after,
               last_after, forced_after, members, retries, failover)
        if self._legacy:
            self._evcache.append(_row_to_event(row, seq))
            self._cache_len = len(self._evcache)
        else:
            if not self._rows:
                self._seq0 = seq
            self._rows.append(row)
        self.last_seq[client] = seq
        key = (kind, rpc_type)
        self._count_by_type[key] = self._count_by_type.get(key, 0) + 1
        self._count_by_kind[kind] = self._count_by_kind.get(kind, 0) + 1
        self._bytes_by_kind[kind] = self._bytes_by_kind.get(kind, 0) + nbytes

    def bulk_account(self, count_by_type: Dict[Tuple[EventKind, str], int],
                     bytes_by_kind: Dict[EventKind, int]) -> None:
        """Apply a bulk kernel's deferred aggregate deltas in one call.

        The bulk execution kernels (:meth:`BaseFS.bulk_write_run` etc.)
        append rows directly and tally aggregates locally per run; the
        deltas are commutative adds, so applying them at run end is
        equivalent to per-event accounting.
        """
        cbt, cbk, bbk = (self._count_by_type, self._count_by_kind,
                         self._bytes_by_kind)
        for key, n in count_by_type.items():
            cbt[key] = cbt.get(key, 0) + n
            kind = key[0]
            cbk[kind] = cbk.get(kind, 0) + n
        for kind, nb in bytes_by_kind.items():
            bbk[kind] = bbk.get(kind, 0) + nb

    def mark_phase(self, name: str) -> None:
        """Global barrier + phase boundary for the cost model."""
        for hook in self.on_barrier:
            hook()
        self.record(EventKind.MARKER, -1, rpc_type=name)

    def clear(self) -> None:
        """Drop all recorded events and every derived aggregate.

        Barrier hooks run first so open send queues flush into the
        *old* event list, not the emptied one.  ``last_seq`` must be
        wiped with the events: it holds virtual-clock anchors (seqs)
        into the cleared list, and a reused ledger would otherwise
        stamp the first post-clear flush with a stale ``last_after``
        pointing at an event that no longer exists.  The vectorized
        replay's lowering cache (:mod:`repro_torch.core.vecreplay`) keys on
        event identity and is likewise invalidated.  The seq counter
        keeps counting — replay only needs seqs contiguous, not
        zero-based.  A previously materialized (or mutated) object view
        is emptied in place and row storage becomes authoritative again.
        """
        for hook in self.on_barrier:
            hook()
        self._rows.clear()
        if self._evcache is not None:
            self._evcache.clear()
        self._mat_rows = 0
        self._cache_len = 0
        self._legacy = False
        self.last_seq.clear()
        self._count_by_type.clear()
        self._count_by_kind.clear()
        self._bytes_by_kind.clear()
        self.__dict__.pop("_vec_lowered", None)
        # Restart the fault counters with the events: a reused ledger
        # re-runs the same seeded schedule from message 0, so identical
        # post-clear workloads get identical stamps.
        if self.faults is not None:
            self.faults.reset()

    # ---- aggregate views used by tests and the cost model ----
    def count(self, kind: EventKind, rpc_type: Optional[str] = None) -> int:
        if rpc_type is None:
            return self._count_by_kind.get(kind, 0)
        return self._count_by_type.get((kind, rpc_type), 0)

    def total_bytes(self, kind: EventKind) -> int:
        return self._bytes_by_kind.get(kind, 0)


# --------------------------------------------------------------------------
# Underlying system-level PFS (Lustre stand-in).
# --------------------------------------------------------------------------
class UnderlyingPFS:
    """Flat byte-addressed files; the slow shared tier below BaseFS.

    Files are :class:`~repro_torch.core.extents.ExtentFile` payload maps:
    overlapping writes overwrite, reads zero-fill gaps and anything past
    EOF — byte-mode semantics, without holding the bytes.
    """

    def __init__(self, ledger: EventLedger, materialize: bool = False) -> None:
        self._files: Dict[str, ExtentFile] = {}
        self._ledger = ledger
        self.materialize = materialize

    def write(self, client: int, path: str, offset: int, data) -> None:
        payload = as_payload(data)
        if self.materialize:
            payload = payload.materialized()
        self._files.setdefault(path, ExtentFile()).write(offset, payload)
        self._ledger.record(EventKind.PFS_WRITE, client, len(payload))

    def read(self, client: int, path: str, offset: int, size: int) -> Payload:
        f = self._files.get(path)
        # ExtentFile.read zero-fills gaps and reads past EOF already; an
        # unknown path is all zeros.
        out = f.read(offset, size) if f is not None else ZeroExtent(size)
        self._ledger.record(EventKind.PFS_READ, client, size)
        return out

    def size(self, path: str) -> int:
        f = self._files.get(path)
        return f.size if f is not None else 0


# --------------------------------------------------------------------------
# Global server (paper §5.1.2), generalized to N hash-partitioned shards
# with client-side RPC batching.  ``num_shards=1, batch=0`` reproduces the
# paper's single-threaded global server byte-for-byte.  Stripe-to-shard
# routing (fixed or adaptive) lives in :mod:`repro_torch.core.routing`;
# ``DEFAULT_STRIPE`` and ``shard_of`` are re-exported here for
# compatibility.
# --------------------------------------------------------------------------


def _coalesce(ivs: List[Interval]) -> List[Interval]:
    """Merge adjacent same-owner intervals gathered from multiple shards."""
    out: List[Interval] = []
    for iv in sorted(ivs, key=lambda v: v.start):
        if out and out[-1].end == iv.start and out[-1].value == iv.value:
            out[-1] = Interval(out[-1].start, iv.end, iv.value)
        else:
            out.append(iv)
    return out


#: Send-queue close reasons recorded in ``Event.flush``.
FLUSH_SIZE = "size"        # the batch filled to ``max_ranges`` descriptors
FLUSH_DEP = "dep"          # a dependent operation needed the RPC's answer
FLUSH_FENCE = "fence"      # consistency-layer sync point (commit/close/sync)
FLUSH_SWITCH = "switch"    # a different rpc type / file / shard followed
FLUSH_BARRIER = "barrier"  # global phase barrier
FLUSH_LINGER = "linger"    # zero-linger queue: intervening client activity
FLUSH_CLOSE = "close"      # deployment drain (end of measured run)

#: Close reasons forced by a GLOBAL event (phase barrier / deployment
#: drain) rather than by the issuing client's own control flow.  Ledger
#: semantics documentation only — the DES takes no
#: distinct pricing path for these: the flush's ledger slot sits
#: exactly where the client entered the barrier/drain, so its chain
#: position IS the barrier-entry clock and the ordinary self-forced
#: formula prices it (capped by the queue's timer; an earlier raw-timer
#: stand-in overheld large-linger tail batches, regression-tested).
TIMER_FORCED = (FLUSH_BARRIER, FLUSH_CLOSE)

#: Flush classes the ack-window model treats as SYNCHRONIZATION points:
#: the issuing chain waits for every outstanding fire-and-forget attach
#: ack (plus this flush's own round trip).  Everything else on an attach
#: queue — size/switch/linger/barrier closes and consumer-forced dep
#: flushes — is fire-and-forget under ``ack_window > 0``; consumer-side
#: ``Event.deps`` edges remain the cross-client correctness backstop.
SYNC_FLUSH = (FLUSH_FENCE, FLUSH_CLOSE)

#: rpc_type of the client-side sync marker recorded when a consistency
#: fence finds an EMPTY send queue but fire-and-forget attach flushes
#: are still unacked: the DES drains the client's ack window there.  No
#: server traffic — the marker carries no payload and costs no
#: master/worker occupancy.
RPC_FENCE_MARKER = "fence"

#: rpc_type of a failover-recovery retransmission: a fire-and-forget
#: attach batch that was in flight to a shard master when it crashed has
#: an unknown fate, so the client REPLAYS it — idempotently, attaches
#: are range upserts — at its next synchronization point, once the
#: standby master has taken over.  Recorded unqueued (blocking), so the
#: DES prices a full round trip at the recovered master and drains the
#: client's ack window there.  See :mod:`repro_torch.core.faults`.
RPC_REPLAY = "replay"

#: Default coalescing window when batching is enabled (seconds).
DEFAULT_LINGER = 50e-6


@dataclass
class _SendQueue:
    """A still-coalescing RPC in a client's send queue: (type, path, shard)."""

    key: Tuple[str, str, int]
    nbytes: int = 0
    nranges: int = 0
    calls: int = 0
    # Virtual-clock anchors: same-client ledger seqs at queue open / last
    # member enqueue (-1 = client had no prior events).
    opened_after: int = -1
    last_after: int = -1
    # Producer edges accumulated by consumer RPCs coalesced in here.
    deps: List[int] = field(default_factory=list)
    # One (anchor_seq, nranges) pair per coalesced call, in enqueue
    # order — the DES re-splits the batch at timer expiries from these.
    members: List[Tuple[int, int]] = field(default_factory=list)


class RPCBatcher:
    """Modeled per-client send queues coalescing attach/query RPCs (opt-in).

    A client's batchable metadata calls are *enqueued*, not recorded:
    while the client keeps issuing the SAME rpc type on the SAME file and
    shard, the ranges accumulate in its send queue.  The queue flushes —
    appending ONE multi-range RPC event to the ledger at the flush
    position — when any of these close triggers fires:

    * **size** — ``max_ranges`` descriptors are packed;
    * **dep** — a dependent operation consumes the RPC's answer: a read
      (``bfs_read``) flushes the reader's open *query* batch, and any
      query/stat on a file flushes every client's open *attach* batch on
      that file (its answer reflects those attaches, so they must have
      been sent first);
    * **fence** — a consistency-layer sync point (commit, session_close,
      MPI file_sync) or any non-batchable RPC by the client;
    * **switch** — the client issues a different (type, file, shard);
    * **barrier** — a ledger phase barrier;
    * **linger** — with a zero ``linger`` window the queue never holds a
      batch across other client activity: any intervening non-RPC event
      by the client sends the queue immediately (batching degenerates to
      back-to-back coalescing only);
    * **close** — :meth:`BaseFS.drain` at the end of a measured run.

    Because the flush event is appended at flush time, a coalesced member
    can never appear in the ledger before data events it logically
    follows.  The flush *timestamp* — and the batch *membership* — is derived by the DES from the queue's virtual clock:
    each batch event carries per-member anchors (``Event.members``), and
    where the linger timer expired strictly before a later member was
    issued the DES RE-SPLITS the batch there — the expired prefix
    departs at its own ``max(last_member, min(forced_close, open +
    linger))`` and the members after the split open a new sub-batch with
    its own window — instead of shipping the ledger-order batch whole.
    A linger expiry therefore fires mid-phase (the RPC overlaps
    subsequent client work) instead of being priced at the next fence or
    barrier.  With ``ack_window=K > 0`` flushed attach batches are
    fire-and-forget: the issuing chain streams past the flush slot and
    stalls only when K flushes are unacked or a sync point (fence,
    drain, any dependent/blocking RPC) forces synchronization.
    Consumer RPCs additionally carry ``deps`` edges on the producer
    flushes they observe (see :meth:`dep_flush_attaches`).  Metadata
    *content* is still applied eagerly at call time (correctness is
    exact); only the RPC traffic's timing is modeled.
    """

    BATCHABLE = ("attach", "query")

    def __init__(self, ledger: EventLedger, max_ranges: int = 0,
                 linger: Optional[float] = None,
                 ack_window: int = 0) -> None:
        self.ledger = ledger
        self.max_ranges = max_ranges
        self.linger = DEFAULT_LINGER if linger is None else float(linger)
        self.ack_window = max(0, ack_window)
        self._open: Dict[int, _SendQueue] = {}
        # Per-client count of fire-and-forget attach flushes since the
        # client's last synchronization point — nonzero means a fence on
        # an EMPTY queue still needs a sync marker so the DES drains the
        # ack window (content was applied eagerly; only timing is owed).
        self._unsynced: Dict[int, int] = {}
        # Fault plane only: per-client detail of those unacked flushes —
        # ``(shard, nbytes, nranges, shard_was_already_failed_over)`` per
        # batch — so the next sync point can decide which were in flight
        # to a master that crashed under them and must be replayed (or,
        # under a lossy schedule, are silently lost).  See _recover().
        self._unsynced_rpcs: Dict[int, List[Tuple[int, int, int, bool]]] = {}
        # Interned (type, path, shard) keys: the streaming hot path
        # re-submits the same key thousands of times per client, and the
        # interned tuple makes the queue-key comparison an identity hit.
        self._keys: Dict[Tuple[str, str, int], Tuple[str, str, int]] = {}
        ledger.on_barrier.append(self._on_barrier)
        ledger.pre_record.append(self._on_client_activity)

    def _on_barrier(self) -> None:
        self.flush_all(FLUSH_BARRIER)
        # A global barrier quiesces the RPC plane: the DES drains every
        # client's outstanding acks into the phase end, so nothing stays
        # unsynced across it — including failover recovery of batches
        # whose master crashed mid-phase.
        if self.ledger.faults is not None:
            for client in list(self._unsynced_rpcs):
                self._recover(client)
        self._unsynced.clear()

    @property
    def enabled(self) -> bool:
        return self.max_ranges > 1

    # ---- close triggers ----------------------------------------------
    def flush(self, client: int, reason: str,
              forced_by: Optional[int] = None) -> Optional[int]:
        """Send the client's open batch: append its RPC event now.

        Returns the flushed event's global seq (``None`` if the queue was
        empty) so consumers can record producer/consumer edges on it.
        The batch event carries the queue's virtual-clock anchors
        (``opened_after``/``last_after``), its linger window, and — for a
        close forced by ANOTHER client (``forced_by``) — that client's
        clock anchor; from these the DES derives the honest flush
        timestamp, which can land mid-phase, strictly before (or, for
        externally-forced closes, after) this ledger slot.
        """
        q = self._open.pop(client, None)
        if q is None:
            return None
        rpc_type, _path, shard = q.key
        faults = self.ledger.faults
        if faults is not None and (rpc_type != "attach"
                                   or reason in SYNC_FLUSH):
            # This flush synchronizes the client (it blocks on the
            # answer / the fence semantics): failover recovery of its
            # earlier in-flight batches happens FIRST, so the replay
            # round trips are ordered before the sync RPC in the chain.
            self._recover(client)
        # Snapshot the shard's failover state BEFORE recording: the
        # recorded message itself may be the one that trips the crash,
        # and a batch sent to the crashing master (not to the already-
        # recovered standby) is the one whose fate is unknown.
        crashed_before = faults is not None and faults.is_crashed(shard)
        forced_after = -1
        if forced_by is not None and forced_by != client:
            forced_after = self.ledger.last_seq.get(forced_by, -1)
        self.ledger.record(
            EventKind.RPC, client, q.nbytes, rpc_type=rpc_type,
            rpc_ranges=q.nranges, shard=shard, rpc_calls=q.calls,
            flush=reason, linger=self.linger, deps=tuple(q.deps),
            opened_after=q.opened_after, last_after=q.last_after,
            forced_after=forced_after, members=tuple(q.members),
        )
        if self.ack_window > 0:
            if rpc_type == "attach" and reason not in SYNC_FLUSH:
                # Fire-and-forget: the ack may still be outstanding when
                # the next fence arrives.
                self._unsynced[client] = self._unsynced.get(client, 0) + 1
                if faults is not None:
                    self._unsynced_rpcs.setdefault(client, []).append(
                        (shard, q.nbytes, q.nranges, crashed_before))
            else:
                # Query flushes (a dependent read consumes the answer),
                # fences and drain closes synchronize the client in the
                # DES — everything before them is acked.
                self._unsynced.pop(client, None)
        return self.ledger.last_recorded_seq

    def _recover(self, client: int) -> None:
        """Failover recovery at a synchronization point (fault plane).

        Every fire-and-forget attach batch the client flushed to a shard
        master that CRASHED after the send (``Event.failover`` tripped
        between flush and this sync point) is replayed as a blocking
        ``RPC_REPLAY`` round trip to the standby — attaches are
        idempotent range upserts, so replay is the correct per-model
        recovery for commit/session/MPI fences alike.  Under a ``lossy``
        schedule the batches are dropped instead and noted on the fault
        state, so the execution tracer refuses to count the fence as a
        formal sync op (the race-checker negative control).  Batches
        sent AFTER the failover went to the healthy standby and need
        nothing.
        """
        faults = self.ledger.faults
        pend = self._unsynced_rpcs.pop(client, None)
        if faults is None or not pend:
            return
        for shard, nbytes, nranges, crashed_before in pend:
            if crashed_before or not faults.is_crashed(shard):
                continue
            if faults.schedule.lossy:
                faults.note_lost(client, shard, nbytes, nranges)
            else:
                self.ledger.record(EventKind.RPC, client, nbytes,
                                   rpc_type=RPC_REPLAY, rpc_ranges=nranges,
                                   shard=shard, failover=1)

    def flush_all(self, reason: str) -> None:
        for client in list(self._open):
            self.flush(client, reason)

    def fence(self, client: int) -> None:
        """Close the client's open batch (consistency-layer sync point).

        Under a nonzero ack window a fence must synchronize even when the
        send queue is EMPTY: earlier fire-and-forget attach flushes may
        still be unacked, and the consistency model's fence (commit,
        session_close, MPI file_sync, file close) does not return until
        they are.  A zero-cost sync marker is recorded for the DES then.
        """
        flushed = self.flush(client, FLUSH_FENCE)
        if flushed is None and self.ledger.faults is not None:
            self._recover(client)
        if (self.ack_window > 0 and flushed is None
                and self._unsynced.pop(client, None)):
            self.ledger.record(EventKind.RPC, client, 0,
                               rpc_type=RPC_FENCE_MARKER)

    def dep_flush_query(self, client: int) -> Optional[int]:
        """A read is about to consume the client's pending query answer."""
        q = self._open.get(client)
        if q is not None and q.key[0] == "query":
            return self.flush(client, FLUSH_DEP)
        return None

    def dep_flush_attaches(self, path: str,
                           by_client: Optional[int] = None) -> List[int]:
        """A query/stat answer on ``path`` reflects every attach applied so
        far — pending attach batches on the file must be sent first.

        ``by_client`` is the querying consumer forcing the flush: it is
        stamped as the producers' ``forced_after`` clock anchor (a
        producer's batch cannot depart before the consumer asked, unless
        its own timer fired first).  Returns the seqs of the flushed
        attach events: the consumer stamps them as ``deps`` so the DES
        blocks its service on the producers' in-flight flushes at the
        shard masters, not merely on ledger order.
        """
        seqs: List[int] = []
        for client, q in list(self._open.items()):
            if q.key[0] == "attach" and q.key[1] == path:
                seq = self.flush(client, FLUSH_DEP, forced_by=by_client)
                if seq is not None:
                    seqs.append(seq)
        return seqs

    def _on_client_activity(self, kind: EventKind, client: int) -> None:
        # Zero-linger send queues never hold a batch while the client does
        # other work; flush BEFORE the intervening event is appended.
        if kind is EventKind.RPC or self.linger > 0.0:
            return
        if client in self._open:
            self.flush(client, FLUSH_LINGER)

    # ---- enqueue ------------------------------------------------------
    def submit(self, rpc_type: str, client: int, path: str, shard: int,
               nranges: int, nbytes: int,
               deps: Tuple[int, ...] = ()) -> None:
        """Enqueue one RPC, coalescing into the client's send queue if legal;
        non-batchable types flush the queue and record immediately.
        ``deps`` are producer-event seqs this RPC's service depends on
        (carried on the recorded event, or accumulated into the queue)."""
        if not (self.enabled and rpc_type in self.BATCHABLE):
            self.flush(client, FLUSH_SWITCH)
            # An unqueued RPC blocks the chain on its round trip — a sync
            # point: failover recovery first, then the RPC, then the DES
            # drains the ack window at it.
            if self.ledger.faults is not None:
                self._recover(client)
            self.ledger.record(EventKind.RPC, client, nbytes,
                               rpc_type=rpc_type, rpc_ranges=nranges,
                               shard=shard, deps=deps)
            self._unsynced.pop(client, None)
            return
        raw = (rpc_type, path, shard)
        key = self._keys.get(raw)
        if key is None:
            key = self._keys.setdefault(raw, raw)
        q = self._open.get(client)
        # Keys are interned above, so identity IS equality here.
        if q is not None and q.key is not key:
            self.flush(client, FLUSH_SWITCH)
            q = None
        if q is not None and q.nranges + nranges > self.max_ranges:
            self.flush(client, FLUSH_SIZE)
            q = None
        if q is None:
            q = self._open[client] = _SendQueue(
                key, opened_after=self.ledger.last_seq.get(client, -1)
            )
        q.nbytes += nbytes
        q.nranges += nranges
        q.calls += 1
        q.last_after = self.ledger.last_seq.get(client, -1)
        q.members.append((q.last_after, nranges))
        for d in deps:
            if d not in q.deps:
                q.deps.append(d)
        if q.nranges >= self.max_ranges:
            self.flush(client, FLUSH_SIZE)

    def submit_run(self, rpc_type: str, client: int, path: str, shard: int,
                   members: List[Tuple[int, int]],
                   deps: Tuple[int, ...] = ()) -> None:
        """Array path: enqueue a whole run of same-(client, type, file,
        shard) submissions in one call.

        ``members`` is ``[(nranges, nbytes), ...]`` for a back-to-back
        run — no intervening ledger event by this client between the
        submissions.  Flush boundaries (the size cap), member clock
        anchors, and dep edges are computed over the full run at once
        instead of per call: every member between two boundaries shares
        one anchor (nothing lands on the client's chain in between), and
        each size flush re-anchors the members after it at the flush
        event's seq.  Bitwise-equivalent to — and property-tested
        against — the same sequence of scalar :meth:`submit` calls.
        """
        if not members:
            return
        if not (self.enabled and rpc_type in self.BATCHABLE):
            for nranges, nbytes in members:
                self.submit(rpc_type, client, path, shard, nranges,
                            nbytes, deps)
            return
        raw = (rpc_type, path, shard)
        key = self._keys.get(raw)
        if key is None:
            key = self._keys.setdefault(raw, raw)
        q = self._open.get(client)
        if q is not None and q.key is not key:
            self.flush(client, FLUSH_SWITCH)
            q = None
        maxr = self.max_ranges
        last_seq = self.ledger.last_seq
        i, m = 0, len(members)
        while i < m:
            anchor = last_seq.get(client, -1)
            if q is None:
                q = self._open[client] = _SendQueue(key,
                                                    opened_after=anchor)
            # Boundary scan: fill the queue up to the size cap in one
            # pass over the remaining run.
            acc = q.nranges
            j = i
            while j < m and acc + members[j][0] <= maxr:
                acc += members[j][0]
                j += 1
            if j == i and q.nranges == 0:
                # A single member larger than the cap sits alone in a
                # fresh queue (the scalar post-check flushes it below).
                acc += members[j][0]
                j += 1
            if j > i:
                nbytes = 0
                for _nr, nb in members[i:j]:
                    nbytes += nb
                q.nbytes += nbytes
                q.nranges = acc
                q.calls += j - i
                q.last_after = anchor
                q.members.extend((anchor, nr) for nr, _nb in members[i:j])
                for d in deps:
                    if d not in q.deps:
                        q.deps.append(d)
                i = j
            if i < m or q.nranges >= maxr:
                self.flush(client, FLUSH_SIZE)
                q = None


_EMPTY_TREE = OwnerIntervalMap()


class _ServerShard:
    """One metadata shard: its own master, worker pool (timed by the DES,
    which round-robins per-shard from the ledger), and owner trees."""

    def __init__(self) -> None:
        self.trees: Dict[str, OwnerIntervalMap] = {}

    def tree(self, path: str) -> OwnerIntervalMap:
        return self.trees.setdefault(path, OwnerIntervalMap())

    def peek(self, path: str) -> OwnerIntervalMap:
        """Read-only lookup: never allocates a tree for an unknown path."""
        return self.trees.get(path, _EMPTY_TREE)


#: Client id charged for server-side stripe migrations (adaptive routing);
#: forms its own DES chain, contending at the shard masters like any RPC.
MIGRATOR_CLIENT = -2


class GlobalServer:
    """Metadata service holding per-file owner interval trees.

    The paper's server is a single node: one master thread dispatching to a
    round-robin worker pool.  This implementation hash-partitions the
    metadata over ``num_shards`` such servers — file stripes map to shards
    via a :mod:`repro_torch.core.routing` router (fixed-width crc32 round-robin
    by default, access-size-adaptive widths + load rebalancing with
    ``adaptive=True``) — so query/attach load from many clients spreads
    over independent masters.  Task *content* runs inline (we are
    single-process); queue *timing* is replayed per shard by the DES.
    With ``num_shards=1`` routing is a no-op and runs match the paper's
    architecture exactly.
    """

    def __init__(self, ledger: EventLedger, num_workers: int = 23,
                 num_shards: int = 1, stripe: int = DEFAULT_STRIPE,
                 batch: int = 0, linger: Optional[float] = None,
                 adaptive: bool = False, ack_window: int = 0) -> None:
        # Catalyst nodes have 24 cores: 1 master + 23 workers (per shard).
        self.ledger = ledger
        self.num_workers = num_workers
        self.num_shards = max(1, num_shards)
        self.stripe = stripe
        self.router: StaticRouter = make_router(num_shards, stripe, adaptive)
        self.shards = [_ServerShard() for _ in range(self.num_shards)]
        self.batcher = RPCBatcher(ledger, batch, linger,
                                  ack_window=ack_window)

    # ---- routing ------------------------------------------------------
    def _split_runs(
        self, path: str, runs: List[Tuple[int, int]]
    ) -> Dict[int, List[Tuple[int, int]]]:
        """Partition byte runs into per-shard stripe-aligned pieces."""
        return self.router.split_runs(path, runs)

    def _observe(self, client: int, path: str, runs: List[Tuple[int, int]],
                 by_shard: Dict[int, List[Tuple[int, int]]]) -> None:
        """Feed the router's load stats and apply any re-layout it decides.

        ``client`` is the accessor whose RPC tipped the router — the
        migration's virtual-clock anchor."""
        self.router.observe(path, runs, by_shard)
        for dirty in sorted(self.router.take_dirty()):
            self._migrate(dirty, client)

    def _migrate(self, path: str, client: int) -> None:
        """Move ``path``'s interval trees to the router's new layout.

        The rebalancing traffic is real: one ``migrate`` RPC per receiving
        shard (priced by the DES at that shard's master) carrying the
        moved range descriptors.
        """
        ivs: List[Interval] = []
        for sh in self.shards:
            tree = sh.trees.pop(path, None)
            if tree is not None:
                ivs.extend(tree)
        if not ivs:
            return
        moved: Dict[int, int] = {}
        for iv in ivs:
            for k, pieces in self.router.split_runs(
                    path, [(iv.start, iv.end)]).items():
                self.shards[k].tree(path).attach_many(pieces, iv.value)
                moved[k] = moved.get(k, 0) + len(pieces)
        # Anchor the migration on the triggering client: the DES schedules
        # the migrate RPCs on the same virtual clock, no earlier than that
        # client's latest recorded event (not at phase start).  When the
        # triggering RPC itself is still coalescing in the client's send
        # queue, the anchor is the client's preceding event — a lower
        # bound on the access's issue time (the batch must not be force-
        # flushed: clients do not observe server-side re-layouts).
        anchor = self.ledger.last_seq.get(client, -1)
        deps = (anchor,) if anchor >= 0 else ()
        for k in sorted(moved):
            self.ledger.record(EventKind.RPC, MIGRATOR_CLIENT,
                               24 * moved[k], rpc_type="migrate",
                               rpc_ranges=moved[k], shard=k, deps=deps)

    def submit(self, rpc_type: str, client: int, nbytes: int,
               shard: int = 0, nranges: int = 1, path: str = "",
               deps: Tuple[int, ...] = ()) -> None:
        """Enqueue the RPC through the send-queue batcher; the DES replays
        the shard's master dispatch + round-robin worker queues from the
        ledger at the batch's flush time on the virtual clock.  ``deps``
        carry producer edges (e.g. a consumer query's dependency on the
        writers' just-flushed attach batches)."""
        self.batcher.submit(rpc_type, client, path, shard, nranges, nbytes,
                            deps=deps)

    # ---- RPC handlers -------------------------------------------------
    def attach(self, client: int, path: str, runs: List[Tuple[int, int]]) -> None:
        # One RPC per involved shard packs that shard's range descriptors
        # (paper: "a single RPC request"; ~3x8B per descriptor).
        by_shard = self._split_runs(path, runs)
        for k, pieces in by_shard.items():
            self.submit("attach", client, 24 * len(pieces), shard=k,
                        nranges=len(pieces), path=path)
            # One windowed splice per multi-range RPC, not per range.
            self.shards[k].tree(path).attach_many(pieces, client)
        self._observe(client, path, runs, by_shard)

    def detach(self, client: int, path: str, runs: List[Tuple[int, int]]) -> bool:
        any_removed = False
        for k, pieces in self._split_runs(path, runs).items():
            self.submit("detach", client, 24 * len(pieces), shard=k,
                        nranges=len(pieces), path=path)
            tree = self.shards[k].tree(path)
            for start, end in pieces:
                any_removed |= tree.detach(start, end, client)
        return any_removed

    def query(self, client: int, path: str, start: int, end: int) -> List[Interval]:
        # The answer reflects every attach applied so far — pending attach
        # batches on this file must be sent (flushed) before the query,
        # and the query carries consumer edges on those flushes so the
        # DES serializes it behind them at the shard masters.
        dep_seqs = tuple(self.batcher.dep_flush_attaches(path, client))
        found: List[Interval] = []
        by_shard = self._split_runs(path, [(start, end)])
        for k, pieces in by_shard.items():
            self.submit("query", client, 24 * len(pieces), shard=k,
                        nranges=len(pieces), path=path, deps=dep_seqs)
            tree = self.shards[k].peek(path)
            for s, e in pieces:
                found.extend(tree.owners(s, e))
        self._observe(client, path, [(start, end)], by_shard)
        # Stitch stripe-split results back into maximal owner runs so the
        # read path issues the same transfers as the unsharded server.
        return _coalesce(found)

    def query_file(self, client: int, path: str) -> List[Interval]:
        dep_seqs = tuple(self.batcher.dep_flush_attaches(path, client))
        # Whole-file queries broadcast: every shard may own stripes.
        found: List[Interval] = []
        for k, sh in enumerate(self.shards):
            self.submit("query", client, 24, shard=k, nranges=1, path=path,
                        deps=dep_seqs)
            tree = sh.peek(path)
            if len(tree):
                found.extend(tree.owners(0, tree.max_end))
        return _coalesce(found)

    def stat_eof(self, client: int, path: str, pfs_size: int) -> int:
        dep_seqs = tuple(self.batcher.dep_flush_attaches(path, client))
        # The file's home shard serves stat (size attr is tracked there in
        # a real system); content-wise we take the max over all shards.
        home = self.router.shard_for(path, 0)
        self.submit("stat", client, 16, shard=home, nranges=1, path=path,
                    deps=dep_seqs)
        eof = max(sh.peek(path).max_end for sh in self.shards)
        return max(eof, pfs_size)


# --------------------------------------------------------------------------
# Client-side state.
# --------------------------------------------------------------------------
SEEK_SET, SEEK_CUR, SEEK_END = 0, 1, 2


@dataclass
class _OpenFile:
    path: str
    pos: int = 0
    local: BufferIntervalMap = field(default_factory=BufferIntervalMap)
    local_eof: int = 0  # max end this client has written/seen


class BFSClient:
    """One logical client process with a node-local burst buffer.

    ``node`` identifies the physical node (several clients share a node's
    SSD in the paper's experiments; the DES charges SSD bandwidth per node).
    """

    def __init__(self, fs: "BaseFS", client_id: int, node: int,
                 tier: str = "ssd") -> None:
        self.fs = fs
        self.id = client_id
        self.node = node
        self.tier = tier  # "ssd" (Intel 910) or "mem" (SCR memory buffer)
        # Node-local burst-buffer file (this client's): an append-only
        # extent log — holds payload descriptors, not bytes.
        self.buffer = ExtentLog()
        self.files: Dict[int, _OpenFile] = {}
        self._next_handle = itertools.count(1)

    # ---- buffer helpers ----
    def _buffer_append(self, payload: Payload) -> int:
        return self.buffer.append(payload)

    def buffer_read(self, buf_start: int, size: int) -> Payload:
        return self.buffer.read(buf_start, size)


#: Process-wide deployment topology used by ``BaseFS()`` when the caller
#: does not pass explicit values: metadata-server shard count, RPC batch
#: size (0 = off), send-queue linger window (seconds; None = default),
#: ack window (unacked fire-and-forget attach flushes a chain may run
#: ahead of; 0 = every flush blocks), stripe width (bytes), adaptive
#: routing, and the data-plane mode (``materialize=True`` = the
#: byte-moving fallback).  ``benchmarks.run --shards/--batch/--linger/
#: --ack-window/--stripe/--adaptive/--materialize`` sets these so every
#: figure (including SCR and DLIO, which build their own BaseFS) runs
#: on the same deployment.
TOPOLOGY = {"shards": 1, "batch": 0, "linger": None, "ack_window": 0,
            "stripe": DEFAULT_STRIPE, "adaptive": False,
            "materialize": False, "faults": None}

#: Sentinel for ``set_topology(faults=...)``: unlike the other knobs,
#: ``None`` is a meaningful faults value (fault-free), so "leave as is"
#: needs its own marker.
_KEEP = object()


def set_topology(shards: Optional[int] = None,
                 batch: Optional[int] = None,
                 linger: Optional[float] = None,
                 stripe: Optional[int] = None,
                 adaptive: Optional[bool] = None,
                 materialize: Optional[bool] = None,
                 ack_window: Optional[int] = None,
                 faults: object = _KEEP) -> None:
    """Set process-wide defaults for the simulated deployment."""
    if shards is not None:
        TOPOLOGY["shards"] = shards
    if batch is not None:
        TOPOLOGY["batch"] = batch
    if linger is not None:
        TOPOLOGY["linger"] = linger
    if stripe is not None:
        TOPOLOGY["stripe"] = stripe
    if adaptive is not None:
        TOPOLOGY["adaptive"] = adaptive
    if materialize is not None:
        TOPOLOGY["materialize"] = materialize
    if ack_window is not None:
        TOPOLOGY["ack_window"] = ack_window
    if faults is not _KEEP:
        TOPOLOGY["faults"] = faults


class BaseFS:
    """The whole simulated deployment: N logical clients + the metadata
    service (1..N shards, see :class:`GlobalServer`).

    Construct once per experiment; create clients with :meth:`client`.
    ``num_shards`` partitions the server metadata; ``batch`` > 1 enables
    client-side RPC send queues with that many range descriptors per
    message; ``linger`` is the queue's coalescing window in seconds (0 =
    send-immediate, ``None`` = :data:`DEFAULT_LINGER`); ``adaptive``
    enables access-size stripe widths + load rebalancing;
    ``ack_window`` bounds the number of unacked fire-and-forget attach
    flushes the DES lets a client chain run ahead of (0 = every flush
    blocks on its round trip — the pre-ack-window model, bitwise);
    ``materialize`` selects the byte-moving data plane (every written
    payload converted to real bytes eagerly — the legacy mode, retained
    as the golden-ledger reference and for RAM/wall-clock comparison;
    the ledger it produces is event-for-event identical by
    construction).  ``None`` means "use the process-wide
    :data:`TOPOLOGY`"; the shipped defaults reproduce the paper's
    configuration on the zero-copy extent plane.
    """

    def __init__(self, num_workers: int = 23,
                 num_shards: Optional[int] = None,
                 stripe: Optional[int] = None,
                 batch: Optional[int] = None,
                 linger: Optional[float] = None,
                 adaptive: Optional[bool] = None,
                 materialize: Optional[bool] = None,
                 ack_window: Optional[int] = None,
                 faults: Optional[object] = None) -> None:
        self.ledger = EventLedger()
        ack = TOPOLOGY["ack_window"] if ack_window is None else ack_window
        self.ledger.ack_window = max(0, int(ack))
        # Fault plane (:mod:`repro_torch.core.faults`): ``faults`` is a seeded
        # FaultSchedule (or an already-started FaultState to share across
        # deployments); ``None`` falls back to the process topology, and
        # an absent/None schedule is the fault-free model — record() and
        # replay stay bitwise-identical to the golden ledgers then.
        sched = TOPOLOGY["faults"] if faults is None else faults
        if sched is not None:
            self.faults = sched.start() if hasattr(sched, "start") else sched
            self.ledger.faults = self.faults
        else:
            self.faults = None
        self.server = GlobalServer(
            self.ledger, num_workers=num_workers,
            num_shards=TOPOLOGY["shards"] if num_shards is None else num_shards,
            stripe=TOPOLOGY["stripe"] if stripe is None else stripe,
            batch=TOPOLOGY["batch"] if batch is None else batch,
            linger=TOPOLOGY["linger"] if linger is None else linger,
            adaptive=(TOPOLOGY["adaptive"] if adaptive is None else adaptive),
            ack_window=self.ledger.ack_window,
        )
        self.materialize = (TOPOLOGY["materialize"] if materialize is None
                            else materialize)
        self.pfs = UnderlyingPFS(self.ledger, materialize=self.materialize)
        self.clients: Dict[int, BFSClient] = {}

    def rpc_fence(self, c: "BFSClient") -> None:
        """Close the client's open RPC batch (consistency-layer sync point)."""
        self.server.batcher.fence(c.id)

    def drain(self) -> None:
        """Flush every open send queue (end of a measured run).

        Call before replaying the ledger or reading aggregate counts so
        tail batches still sitting in client send queues are accounted.
        """
        self.server.batcher.flush_all(FLUSH_CLOSE)

    def client(self, client_id: int, node: Optional[int] = None,
               tier: str = "ssd") -> BFSClient:
        if client_id not in self.clients:
            c = BFSClient(
                self, client_id, node if node is not None else client_id,
                tier=tier,
            )
            self.clients[client_id] = c
            self.ledger.client_node[client_id] = c.node
        return self.clients[client_id]

    # =====================================================================
    # Table 5 primitives.  All take the acting client explicitly.
    # =====================================================================
    def bfs_open(self, c: BFSClient, pathname: str) -> int:
        h = next(c._next_handle)
        c.files[h] = _OpenFile(pathname)
        return h

    def bfs_close(self, c: BFSClient, h: int) -> int:
        # Buffered data is DISCARDED, not flushed (paper Table 5).
        c.files.pop(h, None)
        return 0

    def bfs_write(self, c: BFSClient, h: int, data) -> int:
        """Write ``data`` — real bytes or a lazy :class:`Payload` extent —
        at the current position into the client's burst buffer."""
        f = c.files[h]
        payload = as_payload(data)
        if self.materialize:
            payload = payload.materialized()
        buf_start = c._buffer_append(payload)
        kind = EventKind.MEM_WRITE if c.tier == "mem" else EventKind.SSD_WRITE
        self.ledger.record(kind, c.id, len(payload))
        f.local.record_write(f.pos, f.pos + len(payload), buf_start)
        f.pos += len(payload)
        f.local_eof = max(f.local_eof, f.pos)
        return len(payload)

    def bfs_read(self, c: BFSClient, h: int, size: int,
                 owner: Optional[int]) -> Payload:
        """Read ``size`` bytes at the current position from ``owner``'s buffer.

        owner None  -> read the underlying PFS directly.
        owner == c.id -> local burst-buffer read.
        otherwise   -> client-to-client transfer (RDMA in the paper).

        Returns a lazy :class:`Payload`: compare it against another
        payload (symbolic when both carry extent descriptors) or
        materialize with ``bytes(...)`` when real bytes are needed.
        """
        # Dependency close trigger: the owner being read was resolved from
        # a query answer — the reader's pending query batch must be sent
        # (and, in the DES, completed) before this read can start.
        self.server.batcher.dep_flush_query(c.id)
        f = c.files[h]
        start, end = f.pos, f.pos + size
        if owner is None:
            data = self.pfs.read(c.id, f.path, start, size)
            f.pos = end
            return data
        oc = self.clients.get(owner)
        if oc is None:
            raise BFSError(f"unknown owner client {owner}")
        # Locate the owner's open handle state for this path: owners serve
        # reads from their buffered (attached) writes.
        of = self._find_owner_state(oc, f.path)
        if of is None or not of.local.covers(start, end):
            raise BFSError(
                f"owner {owner} does not own [{start},{end}) of {f.path}"
            )
        parts = []
        for fs_, fe_, bs_ in of.local.buffer_runs(start, end):
            parts.append(oc.buffer_read(bs_, fe_ - fs_))
        data = concat(parts)
        if owner == c.id:
            kind = (EventKind.MEM_READ if c.tier == "mem"
                    else EventKind.SSD_READ)
            self.ledger.record(kind, c.id, size)
        else:
            # Owner reads its device and ships bytes over the interconnect;
            # both costs are charged to the reader's blocking chain by the
            # DES (the peer field carries the owner for node lookup; the
            # rpc_type field tags the owner-side device tier).
            self.ledger.record(EventKind.NET_TRANSFER, c.id, size,
                               rpc_type=oc.tier, peer=owner)
        f.pos = end
        return data

    def _find_owner_state(self, oc: BFSClient, path: str) -> Optional[_OpenFile]:
        for of in oc.files.values():
            if of.path == path:
                return of
        # Owner may have closed the handle but must keep serving attached
        # ranges (the paper keeps a listener thread); retain a shadow map.
        return oc.__dict__.setdefault("_shadow", {}).get(path)

    def _shadow_owner_state(self, c: BFSClient, f: _OpenFile) -> None:
        c.__dict__.setdefault("_shadow", {})[f.path] = f

    def bfs_attach(self, c: BFSClient, h: int, offset: int, size: int) -> int:
        f = c.files[h]
        if not f.local.written(offset, offset + size):
            raise BFSError("attaching unwritten bytes is erroneous (Table 5)")
        runs = [(s, e) for s, e, _ in f.local.buffer_runs(offset, offset + size)]
        self.server.attach(c.id, f.path, runs)
        f.local.mark_attached(offset, offset + size)
        self._shadow_owner_state(c, f)
        return 0

    def bfs_attach_file(self, c: BFSClient, h: int) -> int:
        f = c.files[h]
        runs = [(s, e) for s, e, _ in f.local.unattached_runs()]
        if not runs:
            return 0  # no-op per Table 5
        self.server.attach(c.id, f.path, runs)
        for s, e in runs:
            f.local.mark_attached(s, e)
        self._shadow_owner_state(c, f)
        return 0

    def bfs_query(self, c: BFSClient, h: int, offset: int,
                  size: int) -> List[Interval]:
        f = c.files[h]
        return self.server.query(c.id, f.path, offset, offset + size)

    def bfs_query_file(self, c: BFSClient, h: int) -> List[Interval]:
        f = c.files[h]
        return self.server.query_file(c.id, f.path)

    def bfs_detach(self, c: BFSClient, h: int, offset: int, size: int) -> int:
        f = c.files[h]
        attached = [
            (s, e)
            for s, e, _ in f.local.buffer_runs(
                offset, offset + size, attached=True
            )
        ]
        if not attached:
            raise BFSError("detaching a never-attached range (Table 5)")
        self.server.detach(c.id, f.path, attached)
        f.local.remove(offset, offset + size)
        return 0

    def bfs_detach_file(self, c: BFSClient, h: int) -> int:
        f = c.files[h]
        runs = [(s, e) for s, e, _ in f.local.attached_runs()]
        if not runs:
            return 0  # no-op
        self.server.detach(c.id, f.path, runs)
        for s, e in runs:
            f.local.remove(s, e)
        return 0

    def bfs_flush(self, c: BFSClient, h: int, offset: int, size: int) -> int:
        f = c.files[h]
        for fs_, fe_, bs_ in f.local.buffer_runs(offset, offset + size):
            self.ledger.record(EventKind.SSD_READ, c.id, fe_ - fs_)
            self.pfs.write(c.id, f.path, fs_, c.buffer_read(bs_, fe_ - fs_))
        return 0

    def bfs_flush_file(self, c: BFSClient, h: int) -> int:
        f = c.files[h]
        for iv in list(f.local):
            slot = iv.value
            self.ledger.record(EventKind.SSD_READ, c.id, iv.length)
            self.pfs.write(
                c.id, f.path, iv.start, c.buffer_read(slot.buf_start, iv.length)
            )
        return 0

    def bfs_seek(self, c: BFSClient, h: int, offset: int, whence: int) -> int:
        f = c.files[h]
        if whence == SEEK_SET:
            f.pos = offset
        elif whence == SEEK_CUR:
            f.pos += offset
        elif whence == SEEK_END:
            f.pos = self.bfs_stat_size(c, h) + offset
        else:
            raise BFSError(f"bad whence {whence}")
        return f.pos

    def bfs_tell(self, c: BFSClient, h: int) -> int:
        return c.files[h].pos

    def bfs_stat_size(self, c: BFSClient, h: int) -> int:
        f = c.files[h]
        global_eof = self.server.stat_eof(c.id, f.path, self.pfs.size(f.path))
        return max(global_eof, f.local_eof)

    # =====================================================================
    # Owner resolution shared by the scalar read path and the bulk kernel.
    # =====================================================================
    def bfs_resolve_segs(self, c: BFSClient, h: int, start: int, end: int,
                         owners: List[Interval],
                         ) -> List[Tuple[int, int, Optional[int]]]:
        """Split ``[start, end)`` along owner intervals into read segments.

        Returns ``[(s, e, owner)]`` covering the range: owned segments
        carry the owning client id, unowned gaps the reader's own id
        where its local buffer covers them (local writes are immediately
        visible to the writer, Table 5), and ``None`` for the underlying
        PFS.  This is the resolution the consistency layers' reads use
        (:meth:`repro_torch.core.consistency._LayeredFS._read_resolved`) and
        the bulk read kernel shares it verbatim.
        """
        f = c.files[h]
        segs: List[Tuple[int, int, Optional[int]]] = []
        pos = start
        for iv in sorted(owners, key=lambda v: v.start):
            s, e = max(iv.start, start), min(iv.end, end)
            if s > pos:
                segs.append((pos, s, None))
            if e > s:
                segs.append((s, e, iv.value))
            pos = max(pos, e)
        if pos < end:
            segs.append((pos, end, None))
        resolved: List[Tuple[int, int, Optional[int]]] = []
        for s, e, owner in segs:
            if owner is not None:
                resolved.append((s, e, owner))
                continue
            p = s
            for ls, le, _ in f.local.buffer_runs(s, e):
                if ls > p:
                    resolved.append((p, ls, None))
                resolved.append((ls, le, c.id))
                p = le
            if p < e:
                resolved.append((p, e, None))
        return resolved

    # =====================================================================
    # Columnar bulk execution kernels.
    #
    # These execute a RUN of homogeneous ops from a compiled op program
    # (:mod:`repro_torch.core.ops`) appending row tuples straight into the
    # ledger's columnar store — no per-op Event objects, no per-op
    # method chain.  They are BITWISE-equivalent to the scalar bfs_*
    # sequence under the preconditions the consistency layers check
    # before dispatching here (see ``_LayeredFS.run_ops``); the layer
    # API is the only legal entry (lint rule ANA005) so every
    # ``sync_op_kinds`` hook and fence stays at its recorded position.
    # =====================================================================
    def _bulk_write_run_cols(self, hmap: Dict[int, Tuple[BFSClient, int]],
                             clients: List[int], offsets: List[int],
                             sizes: List[int], lo: int, hi: int,
                             payload_fn) -> None:
        """Columnar write run for the attach-free placements.

        Without the per-write attach (CommitFS/SessionFS/MPIIOFS defer
        publication to their sync op) a write run never touches the
        server, the batcher, or the fault plane — so the kernel splits
        into column passes: payloads materialize in program order (the
        callback may be stateful), ledger rows extend from per-(client,
        nbytes) templates, accounting aggregates over a Counter, and
        only the burst-buffer append walks op-by-op.  Rows, sequence
        anchors, buffer state, and local maps are exactly what
        :meth:`bulk_write_run`'s general loop produces.
        """
        led = self.ledger
        rows = led._rows
        if not rows:
            led._seq0 = led._next_seq
        base = led._next_seq
        pc_l = clients[lo:hi]
        pay = list(map(payload_fn, offsets[lo:hi], sizes[lo:hi]))
        n = len(pay)
        state: Dict[int, tuple] = {}
        cidmap: Dict[int, int] = {}
        mem_cids = set()
        for pc in set(pc_l):
            c, h = hmap[pc]
            f = c.files[h]
            log = c.buffer
            state[pc] = (f, log, log._offs.append, log._parts.append, c)
            cidmap[pc] = c.id
            if c.tier == "mem":
                mem_cids.add(c.id)
        nb_l = [p.nbytes for p in pay]
        cid_l = [cidmap[pc] for pc in pc_l]
        key_l = list(zip(cid_l, nb_l))
        row_cache: Dict[Tuple[int, int], tuple] = {}
        cnt_ssd = nb_ssd = cnt_mem = nb_mem = 0
        for key, kn in _Counter(key_l).items():
            cid, nb = key
            if cid in mem_cids:
                kind = _MEM_W_V
                cnt_mem += kn
                nb_mem += nb * kn
            else:
                kind = _SSD_W_V
                cnt_ssd += kn
                nb_ssd += nb * kn
            row_cache[key] = (kind, cid, nb) + _DATA_TAIL
        rows.extend(map(row_cache.__getitem__, key_l))
        led._next_seq = base + n
        ls = led.last_seq
        lastj: Dict[int, int] = {}
        for j, cid in enumerate(cid_l):
            lastj[cid] = j
        for cid, j in lastj.items():
            ls[cid] = base + j
        spans: Dict[int, list] = {pc: [] for pc in state}
        for pc, off, p, nb in zip(pc_l, offsets[lo:hi], pay, nb_l):
            st = state[pc]
            log = st[1]
            bs = log.nbytes
            st[2](bs)
            st[3](p)
            log.nbytes = bs + nb
            spans[pc].append((off, off + nb, bs))
        for pc, sp in spans.items():
            if not sp:
                continue
            f = state[pc][0]
            contiguous = True
            mx = sp[0][1]
            ps, pe, pb = sp[0]
            for s, e, b in sp[1:]:
                if e > mx:
                    mx = e
                if s != pe or b != pb + (pe - ps):
                    contiguous = False
                    break
                ps, pe, pb = s, e, b
            if not contiguous:
                mx = max(e for _s, e, _b in sp)
                for s, e, b in sp:
                    f.local.record_write(s, e, b)
            else:
                f.local.record_write(sp[0][0], sp[-1][1], sp[0][2])
            f.pos = sp[-1][1]
            if mx > f.local_eof:
                f.local_eof = mx
        counts: Dict[Tuple[EventKind, str], int] = {}
        nbytes: Dict[EventKind, int] = {}
        if cnt_ssd:
            counts[(EventKind.SSD_WRITE, "")] = cnt_ssd
            nbytes[EventKind.SSD_WRITE] = nb_ssd
        if cnt_mem:
            counts[(EventKind.MEM_WRITE, "")] = cnt_mem
            nbytes[EventKind.MEM_WRITE] = nb_mem
        led.bulk_account(counts, nbytes)

    def bulk_write_run(self, hmap: Dict[int, Tuple[BFSClient, int]],
                       clients: List[int], offsets: List[int],
                       sizes: List[int], lo: int, hi: int,
                       payload_fn: Callable[[int, int], Payload],
                       attach: bool = False) -> None:
        """Execute the WRITE ops at columns ``[lo, hi)`` of an op program.

        ``clients``/``offsets``/``sizes`` are the program's columns;
        ``hmap`` maps program client ids to ``(BFSClient, handle)``.
        Equivalent to ``seek(off); bfs_write(payload_fn(off, size))``
        per op — plus the per-write ``bfs_attach`` when ``attach`` is
        set (the PosixFS placement).  Local buffer-map updates are
        deferred to the run end (nothing reads them mid-run; the
        interval maps are canonical, so the final state is identical),
        which turns a contiguous write stream into a single interval
        splice.
        """
        led = self.ledger
        rows = led._rows
        if not rows:
            led._seq0 = led._next_seq
        nseq = led._next_seq
        ls = led.last_seq
        append = rows.append
        server = self.server
        batcher = server.batcher
        batched = attach and batcher.enabled
        shards = server.shards
        nsh = server.num_shards
        w = server.stripe
        faults = led.faults
        if self.materialize:
            raw_fn = payload_fn

            def payload_fn(off, size):  # noqa: F811 - byte-plane wrapper
                return raw_fn(off, size).materialized()
        if not attach:
            # Attach-free placements never touch the server mid-run:
            # the columnar passes record the identical ledger faster.
            return self._bulk_write_run_cols(hmap, clients, offsets,
                                             sizes, lo, hi, payload_fn)
        crc_cache: Dict[str, int] = {}
        row_cache: Dict[Tuple[int, int], tuple] = {}
        # program cid -> (client, open-file, bfs cid, is_mem, spans)
        state: Dict[int, tuple] = {}
        cnt_ssd = nb_ssd = cnt_mem = nb_mem = 0
        cnt_att = nb_att = 0
        for i in range(lo, hi):
            pc = clients[i]
            st = state.get(pc)
            if st is None:
                c, h = hmap[pc]
                st = state[pc] = (c, c.files[h], c.id, c.tier == "mem", [])
            c, f, cid, is_mem, spans = st
            off = offsets[i]
            payload = payload_fn(off, sizes[i])
            n = payload.nbytes
            bs = c.buffer.append(payload)
            rkey = (cid, n)
            row = row_cache.get(rkey)
            if row is None:
                kind = _MEM_W_V if is_mem else _SSD_W_V
                row = row_cache[rkey] = (kind, cid, n) + _DATA_TAIL
            append(row)
            if is_mem:
                cnt_mem += 1
                nb_mem += n
            else:
                cnt_ssd += 1
                nb_ssd += n
            ls[cid] = nseq
            nseq += 1
            end = off + n
            spans.append((off, end, bs))
            f.pos = end
            if end > f.local_eof:
                f.local_eof = end
            if not attach:
                continue
            # PosixFS placement: attach the just-written run.  The range
            # was written by exactly one append, so its buffer runs are
            # the single span — no map lookup needed.
            path = f.path
            if nsh == 1:
                groups = ((0, [(off, end)]),)
            else:
                crc = crc_cache.get(path)
                if crc is None:
                    crc = crc_cache[path] = crc32(path.encode())
                s0, s1 = off // w, (end - 1) // w
                if s0 == s1:
                    groups = (((crc + s0) % nsh, [(off, end)]),)
                else:
                    groups = tuple(
                        server.router.split_runs(path, [(off, end)]).items())
            if batched:
                # Through the batcher's array path: it records any flush
                # events itself, so the seq counter must be live.
                led._next_seq = nseq
                for k, pieces in groups:
                    batcher.submit_run("attach", cid, path, k,
                                       [(len(pieces), 24 * len(pieces))])
                    shards[k].tree(path).attach_many(pieces, cid)
                nseq = led._next_seq
            else:
                for k, pieces in groups:
                    npieces = len(pieces)
                    retries = failover = 0
                    if faults is not None:
                        retries, fo = faults.on_rpc("attach", k)
                        failover = 1 if fo else 0
                    append((_RPC_V, cid, 24 * npieces, "attach", -1,
                            npieces, k, 1, "", 0.0, (), -1, -1, -1, (),
                            retries, failover))
                    ls[cid] = nseq
                    nseq += 1
                    cnt_att += 1
                    nb_att += 24 * npieces
                    shards[k].tree(path).attach_many(pieces, cid)
        led._next_seq = nseq
        for c, f, _cid, _is_mem, spans in state.values():
            if not spans:
                continue
            contiguous = True
            ps, pe, pb = spans[0]
            for s, e, b in spans[1:]:
                if s != pe or b != pb + (pe - ps):
                    contiguous = False
                    break
                ps, pe, pb = s, e, b
            if contiguous:
                f.local.record_write(spans[0][0], spans[-1][1], spans[0][2])
                if attach:
                    f.local.mark_attached(spans[0][0], spans[-1][1])
            else:
                for s, e, b in spans:
                    f.local.record_write(s, e, b)
                if attach:
                    for s, e, _b in spans:
                        f.local.mark_attached(s, e)
            if attach:
                self._shadow_owner_state(c, f)
        counts: Dict[Tuple[EventKind, str], int] = {}
        nbytes: Dict[EventKind, int] = {}
        if cnt_ssd:
            counts[(EventKind.SSD_WRITE, "")] = cnt_ssd
            nbytes[EventKind.SSD_WRITE] = nb_ssd
        if cnt_mem:
            counts[(EventKind.MEM_WRITE, "")] = cnt_mem
            nbytes[EventKind.MEM_WRITE] = nb_mem
        if cnt_att:
            counts[(EventKind.RPC, "attach")] = cnt_att
            nbytes[EventKind.RPC] = nb_att
        led.bulk_account(counts, nbytes)

    def _bulk_read_run_vec(self, hmap: Dict[int, Tuple[BFSClient, int]],
                           clients: List[int], offsets: List[int],
                           sizes: List[int], lo: int, hi: int,
                           expect_fn) -> Optional[int]:
        """Vectorized query-mode read run (numpy), or None to fall back.

        Resolves the whole run at once — stripe/shard mapping, owner-tree
        lookups, and owner buffer-map translation are array ops; only row
        construction and payload verification remain per-read.  Applies
        when every read in the run is single-stripe, lands inside one
        covering owner interval whose local map is a single contiguous
        run, and no fault schedule is armed.  The attempt is *pure* until
        every read has structurally resolved: any non-conforming read
        returns None before the ledger, file positions, or verification
        callback are touched, and the scalar kernel reruns the columns
        from unchanged state.  Committed rows, sequence numbers, and
        accounting are tuple-for-tuple what the scalar kernel records.
        """
        led = self.ledger
        server = self.server
        shards = server.shards
        nsh = server.num_shards
        w = server.stripe
        clmap = self.clients
        RPC = EventKind.RPC
        NET = EventKind.NET_TRANSFER
        MEM_READ = EventKind.MEM_READ
        SSD_READ = EventKind.SSD_READ
        n = hi - lo
        pc_l = clients[lo:hi]
        sz_l = sizes[lo:hi]
        # Per-program-client state: all reads must target one path.
        path = None
        cidmap: Dict[int, int] = {}
        fmap: Dict[int, object] = {}
        mem_cids = set()
        for pc in set(pc_l):
            c, h = hmap[pc]
            f = c.files[h]
            if path is None:
                path = f.path
            elif f.path != path:
                return None
            cidmap[pc] = c.id
            fmap[pc] = f
            if c.tier == "mem":
                mem_cids.add(c.id)
        off_arr = _np.array(offsets[lo:hi], _np.int64)
        sz_arr = _np.array(sz_l, _np.int64)
        end_arr = off_arr + sz_arr
        if nsh == 1:
            k_arr = _np.zeros(n, _np.int64)
        else:
            s0 = off_arr // w
            if not (s0 == (end_arr - 1) // w).all():
                return None
            k_arr = (crc32(path.encode()) + s0) % nsh
        # Owner-tree lookup, one searchsorted per shard.
        owner_arr = _np.empty(n, _np.int64)
        for kv in range(nsh):
            sel = _np.nonzero(k_arr == kv)[0]
            if not sel.size:
                continue
            tree = shards[kv].peek(path)
            ivals = tree._ivals
            if not ivals:
                return None
            tends = _np.array(tree._ends, _np.int64)
            tstarts = _np.array([iv.start for iv in ivals], _np.int64)
            try:
                tvals = _np.array([iv.value for iv in ivals], _np.int64)
            except (TypeError, OverflowError, ValueError):
                return None
            so = off_arr[sel]
            ti = _np.searchsorted(tends, so, side="right")
            if int(ti.max()) >= len(ivals):
                return None
            if not ((tstarts[ti] <= so)
                    & (end_arr[sel] <= tends[ti])).all():
                return None
            owner_arr[sel] = tvals[ti]
        # Owner buffer-map translation: each owner must serve its range
        # from a single contiguous local run (the bulk-write layout).
        uniq, slot = _np.unique(owner_arr, return_inverse=True)
        nu = len(uniq)
        l_lo = _np.empty(nu, _np.int64)
        l_hi = _np.empty(nu, _np.int64)
        buf0 = _np.empty(nu, _np.int64)
        # Owner extent logs, concatenated into one *dense* global byte
        # space (each log's offsets start at 0 and are gapless, so the
        # per-owner byte bases stack): one searchsorted then resolves
        # every read's payload extent at once.
        gparts: List[Payload] = []
        goffs: List[int] = []
        nparts: List[int] = []
        logbytes: List[int] = []
        tiers: List[str] = []
        net_tails: List[tuple] = []
        for j, o in enumerate(uniq.tolist()):
            oc = clmap.get(o)
            if oc is None:
                return None
            of = self._find_owner_state(oc, path)
            if of is None:
                return None
            livals = of.local._ivals
            if len(livals) != 1:
                return None
            iv = livals[0]
            l_lo[j] = iv.start
            l_hi[j] = iv.end
            buf0[j] = iv.value.buf_start
            log = oc.buffer
            gparts.extend(log._parts)
            goffs.extend(log._offs)
            nparts.append(len(log._offs))
            logbytes.append(log.nbytes)
            tier = oc.tier
            tiers.append(tier)
            net_tails.append((tier, o, 1, 0, 1, "", 0.0, (), -1, -1, -1,
                              (), 0, 0))
        ll = l_lo[slot]
        if not ((ll <= off_arr) & (end_arr <= l_hi[slot])).all():
            return None
        bs_arr = buf0[slot] + (off_arr - ll)
        lb = _np.array(logbytes, _np.int64)
        cum = _np.cumsum(lb)
        byte_base = cum - lb
        total_bytes = int(cum[-1]) if nu else 0
        goffs_np = _np.array(goffs, _np.int64) \
            + _np.repeat(byte_base, _np.array(nparts, _np.int64))
        part_nb = _np.diff(goffs_np, append=total_bytes)
        gbs = bs_arr + byte_base[slot]
        gidx = _np.searchsorted(goffs_np, gbs, side="right") - 1
        s_arr = gbs - goffs_np[gidx]
        pn = part_nb[gidx]
        if not (s_arr + sz_arr <= pn).all():
            return None  # multi-extent payloads: the scalar kernel chains
        exact = (s_arr == 0) & (sz_arr == pn)
        cid_l = [cidmap[pc] for pc in pc_l]
        cid_arr = _np.array(cid_l, _np.int64)
        net_mask = owner_arr != cid_arr
        # Row construction: qrow + data row per read.  All-remote runs
        # (the benchmark shape) build both row streams as comprehensions
        # and interleave them at C speed; local reads take a plain loop.
        tails = [(24, "query", -1, 1, kv, 1, "", 0.0, (), -1, -1, -1,
                  (), 0, 0) for kv in range(nsh)]
        k_l = k_arr.tolist()
        sl_l = slot.tolist()
        cnt_loc_ssd = cnt_loc_mem = nb_loc_ssd = nb_loc_mem = 0
        if bool(net_mask.all()):
            qrows = [(_RPC_V, cid) + tails[kv]
                     for cid, kv in zip(cid_l, k_l)]
            drows = [(_NET_V, cid, size) + net_tails[sl]
                     for cid, size, sl in zip(cid_l, sz_l, sl_l)]
            newrows = list(itertools.chain.from_iterable(
                zip(qrows, drows)))
        else:
            ow_l = owner_arr.tolist()
            newrows = []
            ap = newrows.append
            for j in range(n):
                size = sz_l[j]
                cid = cid_l[j]
                ap((_RPC_V, cid) + tails[k_l[j]])
                if ow_l[j] == cid:
                    kind = _MEM_R_V if cid in mem_cids else _SSD_R_V
                    ap((kind, cid, size) + _DATA_TAIL)
                    if cid in mem_cids:
                        cnt_loc_mem += 1
                        nb_loc_mem += size
                    else:
                        cnt_loc_ssd += 1
                        nb_loc_ssd += size
                else:
                    ap((_NET_V, cid, size) + net_tails[sl_l[j]])
        parts_out: Optional[List[Payload]] = None
        if expect_fn is not None:
            if bool(exact.all()):
                parts_out = [gparts[g] for g in gidx.tolist()]
            else:
                ex_l = exact.tolist()
                s_l = s_arr.tolist()
                gi_l = gidx.tolist()
                parts_out = [
                    gparts[g] if hit else gparts[g].slice(s, sz)
                    for g, hit, s, sz in zip(gi_l, ex_l, s_l, sz_l)]
        off_l = off_arr.tolist()
        end_l = end_arr.tolist()
        lastj: Dict[int, int] = {}
        for j, cid in enumerate(cid_l):
            lastj[cid] = j
        lastend: Dict[int, int] = {}
        for pc, e in zip(pc_l, end_l):
            lastend[pc] = e
        # Structural resolution complete — commit, then verify.
        rows = led._rows
        if not rows:
            led._seq0 = led._next_seq
        base_seq = led._next_seq
        rows.extend(newrows)
        led._next_seq = base_seq + 2 * n
        ls = led.last_seq
        for cid, j in lastj.items():
            ls[cid] = base_seq + 2 * j + 1
        for pc, e in lastend.items():
            fmap[pc].pos = e
        counts: Dict[Tuple[EventKind, str], int] = {(RPC, "query"): n}
        nbytes: Dict[EventKind, int] = {RPC: 24 * n}
        if cnt_loc_ssd:
            counts[(SSD_READ, "")] = cnt_loc_ssd
            nbytes[SSD_READ] = nb_loc_ssd
        if cnt_loc_mem:
            counts[(MEM_READ, "")] = cnt_loc_mem
            nbytes[MEM_READ] = nb_loc_mem
        if bool(net_mask.any()):
            nb_net = int(sz_arr[net_mask].sum())
            cnt_net: Dict[str, int] = {}
            per_owner = _np.bincount(slot[net_mask],
                                     minlength=nu).tolist()
            for j, cval in enumerate(per_owner):
                if cval:
                    t = tiers[j]
                    cnt_net[t] = cnt_net.get(t, 0) + cval
            for t, cval in cnt_net.items():
                counts[(NET, t)] = cval
            nbytes[NET] = nb_net
        led.bulk_account(counts, nbytes)
        verified = 0
        if expect_fn is not None:
            # ``key_for`` marks a pure expectation whose symbolic key
            # can be compared against the payload's without building
            # the expected object; a key miss (or keyless payload)
            # falls back to the full comparison.
            kf = getattr(expect_fn, "key_for", None)
            for start, size, part in zip(off_l, sz_l, parts_out):
                if kf is not None:
                    pk = part.key()
                    if pk is not None and pk == kf(start, size):
                        verified += 1
                        continue
                ex = expect_fn(start, size)
                if part is not ex and part != ex:
                    raise AssertionError(
                        f"bulk read mismatch at offset {start}")
                verified += 1
        return verified

    def bulk_read_run(self, hmap: Dict[int, Tuple[BFSClient, int]],
                      clients: List[int], offsets: List[int],
                      sizes: List[int], lo: int, hi: int,
                      owner_maps: Optional[Dict[int, object]] = None,
                      expect_fn=None, query: bool = False) -> int:
        """Execute the READ ops at columns ``[lo, hi)`` of an op program.

        ``clients``/``offsets``/``sizes`` are the program's columns;
        ``hmap`` maps program client ids to ``(BFSClient, handle)``.
        Equivalent to ``seek(off); read(size)`` per op at the layer
        level.  With ``query`` (the PosixFS/CommitFS placement) the
        owner lookup is performed here — the per-shard query RPC rows
        and tree lookups of :meth:`GlobalServer.query`; otherwise
        owners come from ``owner_maps`` (program cid -> the handle's
        SessionFS/MPIIOFS snapshot cache, or None).  Each read's
        payload is verified against ``expect_fn(off, size)`` when
        given; returns the number of reads verified.

        The hot path — a block-aligned read inside one stripe, fully
        inside one owner's range, served by one buffer extent — runs
        on single-bisect lookups (:meth:`IntervalMap.sole_cover` /
        ``sole_run``) and cached row templates; anything else falls
        back to the general grouped-query / segment-resolution code,
        which is row-for-row what the scalar path records.

        Large fault-free query runs first attempt the numpy-vectorized
        resolver (:meth:`_bulk_read_run_vec`); it commits identical rows
        or declines without side effects.
        """
        if (query and _np is not None and hi - lo >= 256
                and self.ledger.faults is None):
            r = self._bulk_read_run_vec(hmap, clients, offsets, sizes,
                                        lo, hi, expect_fn)
            if r is not None:
                return r
        led = self.ledger
        rows = led._rows
        if not rows:
            led._seq0 = led._next_seq
        nseq = led._next_seq
        ls = led.last_seq
        append = rows.append
        server = self.server
        shards = server.shards
        nsh = server.num_shards
        w = server.stripe
        faults = led.faults
        clmap = self.clients
        pfs_files = self.pfs._files
        RPC = EventKind.RPC
        NET = EventKind.NET_TRANSFER
        MEM_READ = EventKind.MEM_READ
        SSD_READ = EventKind.SSD_READ
        crc_cache: Dict[str, int] = {}
        # program cid -> (client, handle, open-file, bfs cid, path,
        # owner snapshot map, path crc, per-shard tree cache, per-path
        # owner-state cache)
        state: Dict[int, tuple] = {}
        path_trees: Dict[str, list] = {}
        path_owners: Dict[str, dict] = {}
        q_tails: Dict[int, tuple] = {}
        loc_rows: Dict[Tuple[int, int], tuple] = {}
        cnt: Dict[Tuple[EventKind, str], int] = {}
        nb: Dict[EventKind, int] = {}
        cnt_q = cnt_loc_ssd = cnt_loc_mem = 0
        nb_q = nb_loc_ssd = nb_loc_mem = nb_net = 0
        cnt_net: Dict[str, int] = {}
        verified = 0
        for i in range(lo, hi):
            pc = clients[i]
            st = state.get(pc)
            if st is None:
                c, h = hmap[pc]
                f = c.files[h]
                path = f.path
                om = None if owner_maps is None else owner_maps.get(pc)
                crc = crc_cache.get(path)
                if crc is None:
                    crc = crc_cache[path] = crc32(path.encode())
                trees = path_trees.get(path)
                if trees is None:
                    trees = path_trees[path] = [None] * nsh
                powners = path_owners.get(path)
                if powners is None:
                    powners = path_owners[path] = {}
                st = state[pc] = (c, h, f, c.id, path, om, crc, trees,
                                  powners)
            c, h, f, cid, path, omap, crc, trees, powners = st
            start = offsets[i]
            size = sizes[i]
            end = start + size
            owner = None
            owners: Optional[List[Interval]] = None
            qrow = None
            if query:
                if nsh == 1:
                    k = 0
                    single = True
                else:
                    s0 = start // w
                    single = s0 == (end - 1) // w
                    if single:
                        k = (crc + s0) % nsh
                if single:
                    retries = failover = 0
                    if faults is not None:
                        retries, fo = faults.on_rpc("query", k)
                        failover = 1 if fo else 0
                    if retries or failover:
                        qrow = (_RPC_V, cid, 24, "query", -1, 1, k, 1,
                                "", 0.0, (), -1, -1, -1, (), retries,
                                failover)
                    else:
                        tail = q_tails.get(k)
                        if tail is None:
                            tail = q_tails[k] = (
                                24, "query", -1, 1, k, 1, "", 0.0, (),
                                -1, -1, -1, (), 0, 0)
                        qrow = (_RPC_V, cid) + tail
                    cnt_q += 1
                    nb_q += 24
                    tv = trees[k]
                    if tv is None:
                        tree = shards[k].peek(path)
                        tv = trees[k] = (tree._ends, tree._ivals, tree)
                    ends, ivals, tree = tv
                    ti = bisect_right(ends, start)
                    if ti < len(ivals):
                        iv = ivals[ti]
                        if iv.start <= start and end <= iv.end:
                            owner = iv.value
                    if owner is None:
                        # No single covering owner: record the query row
                        # now, then the general query + resolution.
                        append(qrow)
                        qrow = None
                        ls[cid] = nseq
                        nseq += 1
                        owners = _coalesce(tree.owners(start, end))
                else:
                    groups = tuple(server.router.split_runs(
                        path, [(start, end)]).items())
                    found: List[Interval] = []
                    for k, pieces in groups:
                        npieces = len(pieces)
                        retries = failover = 0
                        if faults is not None:
                            retries, fo = faults.on_rpc("query", k)
                            failover = 1 if fo else 0
                        append((_RPC_V, cid, 24 * npieces, "query", -1,
                                npieces, k, 1, "", 0.0, (), -1, -1, -1,
                                (), retries, failover))
                        ls[cid] = nseq
                        nseq += 1
                        cnt_q += 1
                        nb_q += 24 * npieces
                        tree = shards[k].peek(path)
                        for s, e in pieces:
                            found.extend(tree.owners(s, e))
                    owners = _coalesce(found)
            elif omap is not None:
                iv = omap.sole_cover(start, end)
                if iv is not None:
                    owner = iv.value
                else:
                    owners = omap.owners(start, end)
            else:
                owners = []
            if owner is not None:
                # Single fully-owned segment: resolve and read without
                # the general segment machinery.
                ost = powners.get(owner)
                if ost is None:
                    oc = clmap.get(owner)
                    if oc is None:
                        raise BFSError(f"unknown owner client {owner}")
                    of = self._find_owner_state(oc, path)
                    if of is None:
                        lends = livals = None
                    else:
                        lm = of.local
                        lends, livals = lm._ends, lm._ivals
                    tier = oc.tier
                    ost = powners[owner] = (
                        oc, of, lends, livals, oc.buffer.read, tier,
                        (tier, owner, 1, 0, 1, "", 0.0, (), -1, -1, -1,
                         (), 0, 0))
                oc, of, lends, livals, bread, otier, net_tail = ost
                bs = None
                if lends is not None:
                    li = bisect_right(lends, start)
                    if li < len(livals):
                        lv = livals[li]
                        if lv.start <= start and end <= lv.end:
                            bs = lv.value.buf_start + (start - lv.start)
                if bs is not None:
                    part = bread(bs, size)
                    if owner == cid:
                        rkey = (cid, size)
                        entry = loc_rows.get(rkey)
                        if entry is None:
                            is_mem = c.tier == "mem"
                            kind = _MEM_R_V if is_mem else _SSD_R_V
                            entry = loc_rows[rkey] = (
                                (kind, cid, size) + _DATA_TAIL, is_mem)
                        row, is_mem = entry
                        if is_mem:
                            cnt_loc_mem += 1
                            nb_loc_mem += size
                        else:
                            cnt_loc_ssd += 1
                            nb_loc_ssd += size
                    else:
                        row = (_NET_V, cid, size) + net_tail
                        cnt_net[otier] = cnt_net.get(otier, 0) + 1
                        nb_net += size
                    if qrow is not None:
                        append(qrow)
                        append(row)
                        ls[cid] = nseq + 1
                        nseq += 2
                    else:
                        append(row)
                        ls[cid] = nseq
                        nseq += 1
                    f.pos = end
                    if expect_fn is not None:
                        ex = expect_fn(start, size)
                        if part is not ex and part != ex:
                            raise AssertionError(
                                f"bulk read mismatch at offset {start}")
                        verified += 1
                    continue
                # Owner's local map is fragmented over the range (or the
                # owner never covered it): the general segment path below
                # reads run-by-run — and raises on a bogus owner.
                if qrow is not None:
                    append(qrow)
                    ls[cid] = nseq
                    nseq += 1
                resolved = [(start, end, owner)]
            else:
                resolved = self.bfs_resolve_segs(c, h, start, end, owners)
            parts: List[Payload] = []
            for s, e, ow in resolved:
                sz = e - s
                if ow is None:
                    pf = pfs_files.get(path)
                    parts.append(pf.read(s, sz) if pf is not None
                                 else ZeroExtent(sz))
                    kind = EventKind.PFS_READ
                    key = (kind, "")
                    append((_PFS_R_V, cid, sz) + _DATA_TAIL)
                else:
                    ost = powners.get(ow)
                    if ost is None:
                        oc = clmap.get(ow)
                        if oc is None:
                            raise BFSError(f"unknown owner client {ow}")
                        of = self._find_owner_state(oc, path)
                        if of is None:
                            lends = livals = None
                        else:
                            lm = of.local
                            lends, livals = lm._ends, lm._ivals
                        tier = oc.tier
                        ost = powners[ow] = (
                            oc, of, lends, livals, oc.buffer.read, tier,
                            (tier, ow, 1, 0, 1, "", 0.0, (), -1, -1, -1,
                             (), 0, 0))
                    oc, of = ost[0], ost[1]
                    if of is None or not of.local.covers(s, e):
                        raise BFSError(
                            f"owner {ow} does not own [{s},{e}) of {path}"
                        )
                    for fs_, fe_, bs_ in of.local.buffer_runs(s, e):
                        parts.append(oc.buffer_read(bs_, fe_ - fs_))
                    if ow == cid:
                        kind = (MEM_READ if c.tier == "mem" else SSD_READ)
                        key = (kind, "")
                        append((kind.value, cid, sz) + _DATA_TAIL)
                    else:
                        # NET rows carry the owner's device tier in
                        # rpc_type (the count-by-type key) and the owner
                        # in peer.
                        kind = NET
                        key = (kind, oc.tier)
                        append((_NET_V, cid, sz, oc.tier, ow, 1, 0, 1,
                                "", 0.0, (), -1, -1, -1, (), 0, 0))
                ls[cid] = nseq
                nseq += 1
                cnt[key] = cnt.get(key, 0) + 1
                nb[kind] = nb.get(kind, 0) + sz
            f.pos = end
            if expect_fn is not None:
                data = parts[0] if len(parts) == 1 else concat(parts)
                if data != expect_fn(start, size):
                    raise AssertionError(
                        f"bulk read mismatch at offset {start}")
                verified += 1
        led._next_seq = nseq
        counts = dict(cnt)
        nbytes = dict(nb)
        if cnt_q:
            counts[(RPC, "query")] = cnt_q
            nbytes[RPC] = nb_q
        if cnt_loc_ssd:
            counts[(SSD_READ, "")] = counts.get((SSD_READ, ""), 0) \
                + cnt_loc_ssd
            nbytes[SSD_READ] = nbytes.get(SSD_READ, 0) + nb_loc_ssd
        if cnt_loc_mem:
            counts[(MEM_READ, "")] = counts.get((MEM_READ, ""), 0) \
                + cnt_loc_mem
            nbytes[MEM_READ] = nbytes.get(MEM_READ, 0) + nb_loc_mem
        if cnt_net:
            for tier, v in cnt_net.items():
                counts[(NET, tier)] = counts.get((NET, tier), 0) + v
            nbytes[NET] = nbytes.get(NET, 0) + nb_net
        led.bulk_account(counts, nbytes)
        return verified

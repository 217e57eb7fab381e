"""Discrete-event cost model replaying BaseFS ledgers (§6 methodology).

BaseFS runs record every SSD access, client-to-client transfer, and
server RPC in an :class:`~repro_torch.core.basefs.EventLedger` (on the
default extent plane no real bytes move — the ledger carries placements
and sizes, which is all pricing needs).
This module reconstructs the *concurrent* timing of that execution on
paper-like hardware (LLNL Catalyst, §6): every client advances through its
own event chain; contention arises only through shared resources —

* the node-local SSD (clients on one node share one device),
* the node NIC (client-to-client "RDMA" reads),
* the metadata server shards (per-shard master dispatch serialization +
  a per-shard round-robin worker pool with FIFO queues — the paper's
  single-server architecture when the ledger carries one shard),
* the underlying PFS (aggregate bandwidth).

The replay is an event-driven simulation: the client with the smallest
clock executes its next event, reserving resources FIFO.  Phase markers in
the ledger act as global barriers and delimit the bandwidth measurements.

Only the *time constants* are modeled; every count and byte replayed here
was measured from the real (in-process) BaseFS execution.  This is the
paper's own isolation argument one level up: the consistency model changes
RPC placement, the ledger records the difference, the DES prices it.

Issue-time vs flush-time costs (time-driven send queues)
--------------------------------------------------------
Data events (SSD/NET/MEM/PFS) are priced at their *issue* point: the
event executes where it sits in the issuing client's chain, reserving the
device FIFO from the client's current clock.  RPC events come in two
flavours:

* **unqueued** (``Event.flush == ""``, i.e. ``batch=0`` or a
  non-batchable type) — also issue-time: the round trip starts at the
  client's clock, exactly the pre-batching model;
* **flushed batches** (``Event.flush`` names a close reason) — priced on
  the send queue's own virtual clock.  Each batch event carries
  per-member anchors (``Event.members``: one same-client ledger seq per
  coalesced call) from which the DES reconstructs when the queue opened
  and when every member was enqueued.  Batch *membership* is
  time-driven: where the queue's linger window ``W`` (``Event.linger``)
  expired strictly before a later member was issued, the DES RE-SPLITS
  the batch at the expiry — the expired prefix departs as its own
  sub-batch at ``max(sub_last_member, sub_open + W)`` and the members
  after the split open a new sub-batch with its own window — instead of
  shipping the ledger-order batch whole.  The FINAL sub-batch departs
  at the recorded close:

      send = max(t_last_member, min(t_forced, t_open + W))

  where ``t_forced`` is the moment the close was really forced: the
  issuing client's chain position for self-forced closes (size cap,
  fence, type/file switch, zero-linger activity) AND for barrier/drain
  closes — the flush's ledger slot sits exactly where the client
  entered the barrier/drain, so the chain position IS its barrier-entry
  clock (an earlier version used the raw timer expiry as a stand-in,
  which overheld large-linger tail batches; a regression test pins that
  the tightened price never undercuts the last member nor exceeds the
  old bound) — or the FORCING client's clock (``Event.forced_after``)
  for a cross-client dep flush, since the producer's chain position
  says nothing about when the consumer asked.  A linger expiry
  therefore fires *mid-phase*: if the timer ran out while the client
  was busy with data events, the sub-batch departs then and its round
  trip overlaps the remaining client work — the chain only blocks if it
  reaches the flush slot before the response is back
  (``clock = max(chain_arrival, t_response)``).  Every sub-batch pays
  ``batch_flush_lat`` (client-side marshalling, chain-only) plus its
  own master dispatch and worker task; server-side per-range work
  (``task_per_range``) is charged at the worker regardless of batching.
  At ``W == 0`` no member can outlive the window (zero-linger queues
  flush on any intervening activity), so every case degenerates to one
  sub-batch with ``send == chain_arrival`` — clock and ledger order
  agree exactly (property-tested).

Ack windows (fire-and-forget attach flushes)
--------------------------------------------
With ``ack_window=K > 0`` (``BaseFS(ack_window=K)``, stamped on the
ledger; ``replay(ack_window=)`` overrides) flushed **attach** batches
are fire-and-forget: the issuing chain does NOT wait for the response
at the flush slot and keeps streaming.  The chain stalls only when

* K flush responses are outstanding — the chain (and the next send)
  waits for the oldest ack, a bounded send-credit window; or
* a synchronization point arrives: a fence/drain-reason flush, any
  blocking RPC (query flushes, unqueued types), or the zero-cost
  ``fence`` marker the batcher records when a consistency fence finds
  an empty queue — each drains every outstanding ack first.

Send credits are PER CONNECTION (client, shard) by default
(``ack_scope="connection"``): each client-to-shard-master FIFO link has
its own K-deep credit window, so a slow or failed-over shard stalls
only the sends on its own link while the client keeps streaming to
healthy shards.  Synchronization points still drain EVERY connection of
the client.  With a single shard the two scopes coincide bitwise;
``ack_scope="global"`` retains the legacy one-gate-per-client model for
comparison.

Phase barriers quiesce the RPC plane: outstanding acks extend the phase
end and are cleared.  Cross-client visibility stays exact: consumers'
``Event.deps`` edges still block their service on the producers'
flushes at the shard masters.  ``ack_window=0`` reproduces the blocking
model bitwise.

Fault pricing (``faults``)
--------------------------
A ledger recorded under a seeded :class:`~repro_torch.core.faults.
FaultSchedule` carries per-event stamps (``Event.retries`` /
``Event.failover``) decided at execution time; the replay prices them
(``faults=None`` resolves the schedule from ``ledger.faults``; pass an
explicit schedule to re-price the same stamps under different timing
constants):

* each of a message's ``retries`` failed attempts delays its successful
  send by ``rpc_timeout + backoff_base * 2**attempt`` and counts as a
  wire message in ``rpc_msgs`` (and ``rpc_retries``) — retries are
  never free;
* the first ``failover``-stamped message serviced at a shard prices a
  ``recovery_window`` blackout at that shard's master (standby
  promotion) and counts in ``failovers``;
* ``slow_shards`` multiplies a shard's master/worker service times; the
  excess is accounted in ``degraded_time``.

Full rules and the recovery semantics live in ``docs/FAULTS.md``.

Cross-client dependency edges
-----------------------------
``Event.deps`` names producer events whose *server-side effect* this
RPC's service must observe: a consumer query that dep-flushed writers'
attach batches cannot be serviced at the shard master before those
flushes have been serviced there (their content is what the answer
reflects).  The replay honours these edges with a blocked-waiter table —
a client whose next event has an unserviced dependency parks until the
producer's RPC completes at its shard, then resumes with its service
start clamped to the producer's completion.  Edges always point to
strictly earlier ledger seqs, so the wait graph is acyclic.  The default
deployment (``num_shards=1, batch=0``) emits no edges and replays
event-for-event as the pre-batching model.

Engines
-------
The per-event loop in this module is the *scalar reference engine* —
the spec every pricing rule is defined against, and the only engine
with diagnostics (traces, forced-order replays).
``replay(engine="vector")`` routes to the struct-of-arrays engine in
:mod:`repro_torch.core.vecreplay`, which returns bitwise-identical
:class:`PhaseResult` values and is faster at scale and on repeated
re-pricing; the full contract and the vector mapping live in
``docs/REPLAY.md``.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.core.basefs import (RPC_FENCE_MARKER, SYNC_FLUSH, Event,
                                     EventKind, EventLedger)


@dataclass(frozen=True)
class HardwareConstants:
    """Catalyst-like constants (paper §6 + Intel 910 / IB QDR datasheets).

    Devices are modeled as queued resources with TWO cost components:

    * ``*_op`` — per-operation DEVICE occupancy (serialized at the device;
      this is what keeps 8KB accesses below peak bandwidth, as in Fig 3),
    * ``*_lat`` — end-to-end issue latency experienced only by the CALLING
      client's chain (an NVMe device at queue depth 12 overlaps the
      latencies of concurrent requests — they do not serialize the device).

    The global server master is single-threaded (paper §5.1.2: "the master
    thread handles all communications"): every RPC costs
    ``server_occupancy`` SERIALIZED at the master.  This is the resource
    whose saturation produces the paper's commit-vs-session gap — query
    RPCs from hundreds of concurrent small reads queue at the master while
    the actual data path (SSD/RDMA) is fast.  30us per RPC round trip
    (recv + dispatch + marshal + send on IB verbs, single thread) matches
    the scale at which the paper's Fig 4b/5/6 gaps open.
    """

    ssd_write_bw: float = 1.0e9      # B/s, peak sequential (paper)
    ssd_read_bw: float = 2.0e9       # B/s, peak sequential (paper)
    ssd_write_op: float = 20e-6      # s, per-op device occupancy (QD-12 amortized)
    ssd_read_op: float = 10e-6       # s, per-op device occupancy
    ssd_write_lat: float = 30e-6     # s, chain-only issue latency
    ssd_read_lat: float = 60e-6      # s, chain-only issue latency
    net_bw: float = 3.2e9            # B/s per node NIC (IB QDR)
    net_op: float = 1e-6             # s, NIC per-message occupancy
    net_lat: float = 2e-6            # s, RDMA one-way (chain only)
    rpc_net_lat: float = 5e-6        # s, client<->server one way (chain)
    batch_flush_lat: float = 3e-6    # s, per-flush multi-range marshal (chain)
    server_occupancy: float = 30e-6  # s, serialized master per RPC round trip
    task_service: float = 5e-6       # s, worker base service per task
    task_per_range: float = 0.2e-6   # s, per 24-byte range descriptor
    server_workers: int = 23         # paper: 24 cores = 1 master + workers
    mem_bw: float = 10e9             # B/s, node memory buffer (SCR)
    mem_op: float = 0.2e-6           # s, per-op occupancy
    mem_lat: float = 0.5e-6          # s, chain-only
    pfs_bw: float = 10e9             # B/s aggregate Lustre
    pfs_op: float = 20e-6
    pfs_lat: float = 100e-6


@dataclass
class PhaseResult:
    name: str
    duration: float                  # makespan of the phase (s)
    bytes_by_kind: Dict[EventKind, int] = field(default_factory=dict)
    rpc_count: int = 0               # ledger RPC events priced in the phase
    clients: int = 0
    # RPC *messages* the DES actually priced: timer-split batches ship
    # as several sub-batch messages for one ledger event, so this can
    # exceed ``rpc_count`` — the honest wire traffic under time-driven
    # membership (client-side fence markers are free and not counted).
    rpc_msgs: int = 0
    # Fault plane (``docs/FAULTS.md``): failed wire attempts priced in
    # the phase (each also counted in ``rpc_msgs``), shard-master
    # failovers whose recovery window was priced in the phase, and the
    # total extra service seconds charged by slow-shard (degraded
    # service) multipliers.  All zero under ``faults=None``.
    rpc_retries: int = 0
    failovers: int = 0
    degraded_time: float = 0.0

    def bandwidth(self, *kinds: EventKind) -> float:
        """Aggregate B/s over the phase for the given event kinds."""
        total = sum(self.bytes_by_kind.get(k, 0) for k in kinds)
        return total / self.duration if self.duration > 0 else 0.0

    @property
    def io_bandwidth(self) -> float:
        return self.bandwidth(
            EventKind.SSD_WRITE,
            EventKind.SSD_READ,
            EventKind.NET_TRANSFER,
            EventKind.MEM_READ,
            EventKind.MEM_WRITE,
            EventKind.PFS_READ,
            EventKind.PFS_WRITE,
        )


class ReplayResult(List[PhaseResult]):
    """``List[PhaseResult]`` plus replay-engine observability.

    Behaves exactly like the list every existing caller indexes and
    iterates; two extra attributes say how the ledger was actually
    priced:

    * ``engine`` — the implementation that ran: ``"scalar"`` or
      ``"vector"``.
    * ``fallback_reason`` — non-``None`` exactly when
      ``engine="vector"`` was *requested* but the scalar reference path
      ran instead (the ledger could not be lowered); carries the
      :class:`~repro_torch.core.vecreplay.UnsupportedLedger` message.

    The perf harness copies both fields into its bench JSON rows so a
    silent scalar fallback can never masquerade as a vector timing.
    """

    def __init__(self, phases: Iterable[PhaseResult] = (),
                 engine: str = "scalar",
                 fallback_reason: Optional[str] = None) -> None:
        super().__init__(phases)
        self.engine = engine
        self.fallback_reason = fallback_reason


class _Resource:
    """FIFO resource with an availability clock."""

    __slots__ = ("avail",)

    def __init__(self) -> None:
        self.avail = 0.0

    def reserve(self, ready: float, duration: float) -> float:
        """Occupy starting no earlier than ``ready``; return finish time."""
        start = max(self.avail, ready)
        self.avail = start + duration
        return self.avail


@dataclass(frozen=True)
class FlushTrace:
    """Virtual-clock timing of one flushed send-queue batch (diagnostics).

    ``send < chain_arrival`` is the mid-phase close: the linger timer (or
    the last member) released the batch strictly before the client chain
    reached the batch's ledger slot, so the round trip overlapped client
    work that the ledger orders after it.  A timer-split batch ships as
    ``splits`` sub-batch messages: ``send`` is the FIRST sub-batch's
    departure, ``response`` the LAST sub-batch's completed round trip,
    and ``sends`` every sub-batch departure in order.
    """

    event: Event
    phase: str
    opened: float         # queue opened (first member enqueued)
    last_member: float    # last member enqueued
    chain_arrival: float  # client chain reached the flush ledger slot
    send: float           # honest departure on the virtual clock
    dep_wait: float       # extra service delay from cross-client edges (s)
    response: float       # round trip completed back at the client
    splits: int = 1       # sub-batch messages after timer re-splitting
    sends: Tuple[float, ...] = ()   # per-sub-batch departures
    blocking: bool = True  # chain waited for the response (ack_window=0
    #                        or a sync-class flush); False = fire-and-forget
    ack_wait: float = 0.0  # chain stall waiting for send credit (s)


class CostModel:
    def __init__(self, hw: Optional[HardwareConstants] = None) -> None:
        self.hw = hw or HardwareConstants()

    # ------------------------------------------------------------------
    def replay(self, ledger: EventLedger,
               trace: Optional[List[Tuple[Event, float, float]]] = None,
               flush_trace: Optional[List[FlushTrace]] = None,
               honor_edges: bool = True,
               record_order: Optional[List[int]] = None,
               exec_order: Optional[List[int]] = None,
               ack_window: Optional[int] = None,
               record_splits: Optional[Dict[int, Tuple[int, ...]]] = None,
               exec_splits: Optional[Dict[int, Tuple[int, ...]]] = None,
               engine: str = "scalar",
               faults: Optional[object] = None,
               ack_scope: str = "connection",
               ) -> "ReplayResult":
        """Price the ledger; optionally append per-event ``(event, start,
        finish)`` DES times to ``trace`` (for a flushed batch, ``start``
        is its virtual-clock departure) and per-batch :class:`FlushTrace`
        records to ``flush_trace``.

        ``engine`` selects the replay implementation: ``"scalar"`` (this
        per-event loop — the reference oracle) or ``"vector"`` (the
        struct-of-arrays engine in :mod:`repro_torch.core.vecreplay`, bitwise
        result-identical and several times faster at scale; see
        ``docs/REPLAY.md``).  Diagnostics (``trace``, ``flush_trace``,
        ``record_order``/``exec_order``, ``record_splits``/
        ``exec_splits``) are scalar-only; the vector engine rejects
        them.  A ledger the vector engine cannot lower (non-contiguous
        seqs from a hand-built ledger, or a fault-stamped one) falls
        back to the scalar path — results are identical either way,
        and the returned :class:`ReplayResult` reports the substitution
        in ``fallback_reason`` (``engine`` says which path really ran).

        ``ack_window`` bounds the unacked fire-and-forget attach flushes
        a client chain may run ahead of; ``None`` uses the deployment's
        own ``ledger.ack_window`` (0 = blocking, the pre-ack model).

        ``honor_edges=False`` ignores ``Event.deps`` entirely — the
        optimistic pre-edge model, where a consumer can be serviced
        before its producer's in-flight flush.  Because ignoring edges
        also *reorders* the greedy schedule, its makespan is not a lower
        bound of the honest one (FIFO scheduling anomalies cut both
        ways).  For a sound "what did the edges cost" comparison, pass
        ``record_order`` (a list the replay fills with the executed seq
        sequence) and re-replay with ``exec_order`` set to it plus
        ``honor_edges=False``: the forced-order counterfactual reserves
        every resource in the SAME order and differs only by the
        dependency waits, so each of its timestamps — and the makespan —
        is pointwise <= the honest replay's (max-plus monotonicity; the
        edge-monotonicity property tests rely on this).  Timer-split
        membership adds a structural degree of freedom to that argument:
        pass ``record_splits`` (a dict the replay fills with each
        flushed event's sub-batch boundaries) and re-replay with
        ``exec_splits`` set to it so the counterfactual ships the SAME
        sub-batch messages — recomputing the splits under relaxed costs
        could change the message count and break pointwise dominance.
        The same record/exec pair makes ack-window comparisons sound
        (the ``ack_window`` monotonicity property tests rely on it).

        ``faults`` prices a fault-stamped ledger (see the module
        docstring and ``docs/FAULTS.md``); ``None`` resolves the
        schedule from ``ledger.faults``, so a ledger recorded under
        ``BaseFS(faults=...)`` prices its own schedule by default.
        ``ack_scope`` selects per-``"connection"`` (client, shard) send
        credits — the default FIFO-link model — or the legacy
        ``"global"`` one-gate-per-client window."""
        if engine not in ("scalar", "vector"):
            raise ValueError(f"unknown replay engine {engine!r}")
        fallback_reason: Optional[str] = None
        if ack_scope not in ("connection", "global"):
            raise ValueError(f"unknown ack_scope {ack_scope!r}")
        if engine == "vector":
            if faults is not None or ack_scope != "connection":
                # A ledger-attached schedule falls back to the scalar
                # path automatically (lower() raises UnsupportedLedger);
                # only explicit scalar-only arguments are an error here.
                raise ValueError(
                    "engine='vector' supports neither an explicit "
                    "faults= override nor ack_scope='global'; use "
                    "engine='scalar'")
            diagnostics = (trace, flush_trace, record_order, exec_order,
                           record_splits, exec_splits)
            if any(d is not None for d in diagnostics):
                raise ValueError(
                    "engine='vector' does not support replay diagnostics "
                    "(trace/flush_trace/record_order/exec_order/"
                    "record_splits/exec_splits); use engine='scalar'")
            from repro_torch.core import vecreplay
            try:
                return ReplayResult(
                    vecreplay.replay_vectorized(
                        self.hw, ledger, ack_window=ack_window,
                        honor_edges=honor_edges),
                    engine="vector")
            except vecreplay.UnsupportedLedger as exc:
                # Scalar reference path below; the substitution is
                # surfaced, not silent (satellite: observability).
                fallback_reason = str(exc)
        if faults is None:
            faults = getattr(ledger, "faults", None)
        fsched = (getattr(faults, "schedule", faults)
                  if faults is not None else None)
        slow: Dict[int, float] = (dict(fsched.slow_shards)
                                  if fsched is not None else {})
        per_conn = ack_scope == "connection"
        hw = self.hw
        node_of = dict(ledger.client_node)
        # Split the ledger at markers into phases.
        phases: List[Tuple[str, List[Event]]] = []
        cur: List[Event] = []
        cur_name = "phase0"
        for e in ledger.events:
            if e.kind is EventKind.MARKER:
                if cur:
                    phases.append((cur_name, cur))
                cur, cur_name = [], e.rpc_type or f"phase{len(phases)}"
            else:
                cur.append(e)
        if cur:
            phases.append((cur_name, cur))

        results: List[PhaseResult] = []
        # Resource clocks persist across phases (devices do not reset),
        # but each phase begins at the global barrier time.
        node_ssd: Dict[int, _Resource] = {}
        node_nic: Dict[int, _Resource] = {}
        node_mem: Dict[int, _Resource] = {}
        # One master + one worker pool PER metadata shard (Event.shard).
        # A single-shard ledger reproduces the paper's one global server.
        shard_master: Dict[int, _Resource] = {}
        shard_workers: Dict[int, List[_Resource]] = {}
        shard_rr: Dict[int, int] = {}
        pfs = _Resource()
        now = 0.0  # global barrier time

        def res(table: Dict[int, _Resource], key: int) -> _Resource:
            if key not in table:
                table[key] = _Resource()
            return table[key]

        # Fault-pricing accumulators (docs/FAULTS.md).  ``failover_paid``
        # persists across phases — a shard fails over once; the other
        # cells are per-phase deltas snapshotted around each phase.
        failover_paid: Set[int] = set()
        degraded_acc = [0.0]
        failover_acc = [0]

        def service(shard: int, arrive: float, nranges: int,
                    failover: bool = False) -> float:
            """Master dispatch + round-robin worker task for one RPC
            message at ``shard``; returns the server-side completion."""
            occ = hw.server_occupancy
            task = hw.task_service + max(1, nranges) * hw.task_per_range
            if slow:
                m = slow.get(shard)
                if m is not None:
                    degraded_acc[0] += (occ + task) * (m - 1.0)
                    occ *= m
                    task *= m
            master = res(shard_master, shard)
            if failover and fsched is not None and shard not in failover_paid:
                # First message serviced at the crashed master: the
                # standby's promotion blackout delays everything queued
                # behind it (recorded once per shard).
                failover_paid.add(shard)
                failover_acc[0] += 1
                master.avail = (max(master.avail, arrive)
                                + fsched.recovery_window)
            dispatched = master.reserve(arrive, occ)
            if shard not in shard_workers:
                shard_workers[shard] = [
                    _Resource() for _ in range(hw.server_workers)
                ]
                shard_rr[shard] = 0
            workers = shard_workers[shard]
            rr = shard_rr[shard]
            # Batched RPCs carry many range descriptors in one
            # round-trip; the worker pays per descriptor.
            done = workers[rr].reserve(dispatched, task)
            shard_rr[shard] = (rr + 1) % len(workers)
            return done

        # Virtual-clock bookkeeping.  ``chain_done`` records the chain
        # finish time of events referenced as send-queue anchors
        # (opened_after/last_after); ``effect_done`` records the
        # server-side completion of events referenced by dependency
        # edges.  Both persist across phases (anchors/edges may point
        # behind a barrier, where they are trivially satisfied).
        referenced: Set[int] = set()
        for e in ledger.events:
            if e.opened_after >= 0:
                referenced.add(e.opened_after)
            if e.last_after >= 0:
                referenced.add(e.last_after)
            if e.forced_after >= 0:
                referenced.add(e.forced_after)
            referenced.update(e.deps)
            for a, _nr in e.members:
                if a >= 0:
                    referenced.add(a)
        chain_done: Dict[int, float] = {}
        effect_done: Dict[int, float] = {}
        op_ptr = 0  # consumed prefix of ``exec_order`` (forced replays)
        # Ack-window state: per-client, per-connection heaps of
        # outstanding (unacked) fire-and-forget flush responses.  The
        # connection key is the destination shard (``ack_scope=
        # "connection"``, the FIFO-link model) or 0 (``"global"``, the
        # legacy one-gate-per-client window — identical whenever one
        # shard is in play).  The credit gate pops only its own
        # connection's heap; sync points and phase barriers drain every
        # connection of the client.
        ack_K = (getattr(ledger, "ack_window", 0) if ack_window is None
                 else max(0, ack_window))
        unacked: Dict[int, Dict[int, List[float]]] = {}

        def drain_acks(c: int, t: float) -> float:
            """Synchronize client ``c``: wait out every outstanding ack
            on every connection; returns the advanced clock."""
            conns = unacked.get(c)
            if conns:
                for pend in conns.values():
                    if pend:
                        t = max(t, max(pend))
                        pend.clear()
            return t

        for name, events in phases:
            # Per-client chains, concurrent within the phase.
            chains: Dict[int, List[Event]] = {}
            for e in events:
                chains.setdefault(e.client, []).append(e)
            clock: Dict[int, float] = {c: now for c in chains}
            idx: Dict[int, int] = {c: 0 for c in chains}
            bytes_by_kind: Dict[EventKind, int] = {}
            rpc_count = 0
            rpc_msgs = 0
            rpc_retries = 0
            degraded0 = degraded_acc[0]
            failover0 = failover_acc[0]

            def execute(e: Event) -> None:
                nonlocal rpc_count, rpc_msgs, rpc_retries
                c = e.client
                t = clock[c]
                start = t
                node = node_of.get(c, c)
                k, nb = e.kind, e.nbytes
                if k is EventKind.SSD_WRITE:
                    t = res(node_ssd, node).reserve(
                        t, hw.ssd_write_op + nb / hw.ssd_write_bw
                    ) + hw.ssd_write_lat
                elif k is EventKind.SSD_READ:
                    t = res(node_ssd, node).reserve(
                        t, hw.ssd_read_op + nb / hw.ssd_read_bw
                    ) + hw.ssd_read_lat
                elif k is EventKind.NET_TRANSFER:
                    # Owner-side device read, then NIC transfer owner->reader.
                    onode = node_of.get(e.peer, e.peer)
                    if e.rpc_type == "mem":
                        t = res(node_mem, onode).reserve(
                            t, hw.mem_op + nb / hw.mem_bw
                        ) + hw.mem_lat
                    else:
                        t = res(node_ssd, onode).reserve(
                            t, hw.ssd_read_op + nb / hw.ssd_read_bw
                        ) + hw.ssd_read_lat
                    t = res(node_nic, onode).reserve(
                        t, hw.net_op + nb / hw.net_bw
                    ) + hw.net_lat
                elif k is EventKind.MEM_WRITE:
                    t = res(node_mem, node).reserve(
                        t, hw.mem_op + nb / hw.mem_bw
                    ) + hw.mem_lat
                elif k is EventKind.MEM_READ:
                    t = res(node_mem, node).reserve(
                        t, hw.mem_op + nb / hw.mem_bw
                    ) + hw.mem_lat
                elif k is EventKind.PFS_WRITE:
                    t = pfs.reserve(t, hw.pfs_op + nb / hw.pfs_bw) + hw.pfs_lat
                elif k is EventKind.PFS_READ:
                    t = pfs.reserve(t, hw.pfs_op + nb / hw.pfs_bw) + hw.pfs_lat
                elif k is EventKind.RPC and e.rpc_type == RPC_FENCE_MARKER:
                    # Client-side sync marker (ack windows): a fence hit
                    # an empty send queue while fire-and-forget flushes
                    # were still unacked — the chain drains them here.
                    # No server traffic, no wire message.
                    t = drain_acks(c, t)
                elif k is EventKind.RPC and e.flush:
                    rpc_count += 1
                    # Time-driven send queue: reconstruct every member's
                    # enqueue clock from the per-member anchors and
                    # RE-SPLIT the batch wherever the linger window
                    # expired strictly before the next member was issued
                    # — membership is time-decided, not ledger-decided.
                    # Each sub-batch ships as its own RPC message.
                    W = e.linger
                    splittable = bool(e.members)
                    if splittable:
                        mt = [max(now, chain_done.get(a, now))
                              for a, _nr in e.members]
                        mranges = [nr for _a, nr in e.members]
                    else:
                        # Aggregate-anchor fallback (hand-built ledgers
                        # without per-member metadata): one pseudo-member
                        # per anchor, never split — exactly the earlier
                        # shape (one message, clamped to the last
                        # member; the zero-range open pseudo-member only
                        # anchors the window).
                        t_open = max(now, chain_done.get(e.opened_after,
                                                         now))
                        mt = [t_open,
                              max(t_open, chain_done.get(e.last_after,
                                                         now))]
                        mranges = [0, max(1, e.rpc_ranges)]
                    if not splittable:
                        bounds = ()
                    elif exec_splits is not None:
                        bounds = exec_splits.get(e.seq, ())
                    else:
                        bounds_l = []
                        open_t = mt[0]
                        for i in range(1, len(mt)):
                            if mt[i] > open_t + W:
                                bounds_l.append(i)
                                open_t = mt[i]
                        bounds = tuple(bounds_l)
                    if record_splits is not None:
                        record_splits[e.seq] = bounds
                    # Fire-and-forget eligibility: attach batches whose
                    # close is not itself a sync point.  Fences and
                    # drain closes synchronize; query flushes block on
                    # their answer (a dependent read consumes it).
                    is_async = (ack_K > 0 and e.rpc_type == "attach"
                                and e.flush not in SYNC_FLUSH)
                    if ack_K > 0:
                        heap = unacked.setdefault(c, {}).setdefault(
                            e.shard if per_conn else 0, [])
                    else:
                        heap = None
                    dep_ready = None
                    dep_wait = 0.0
                    if honor_edges and e.deps:
                        # Producer edges: service cannot start before the
                        # producers' RPCs completed at their shards.
                        dep_ready = max(effect_done.get(d, now)
                                        for d in e.deps)
                    chain_arrival = t
                    ack_wait = 0.0
                    sends: List[float] = []
                    effect = now
                    resp = now
                    starts_ = (0, *bounds)
                    ends_ = (*bounds, len(mt))
                    for gi, (lo, hi) in enumerate(zip(starts_, ends_)):
                        if lo >= hi:
                            continue  # degenerate replayed boundary
                        t_open_g = mt[lo]
                        t_last_g = mt[hi - 1]
                        if hi < len(mt):
                            # Timer split: the window expired strictly
                            # before member ``hi`` was issued, so this
                            # sub-batch departed on its own timer (never
                            # before its last member — the clamp matters
                            # only under a replayed split plan, where
                            # member clocks can differ from the
                            # recording run's).
                            send = max(t_last_g, t_open_g + W)
                        else:
                            # Final sub-batch: the recorded close.  The
                            # force moment is the issuing client's chain
                            # position — for barrier/drain closes that
                            # IS its barrier-entry clock (tightened from
                            # an earlier raw-timer stand-in) — or the
                            # forcing client's clock for a cross-client
                            # dep flush.
                            if e.forced_after >= 0:
                                t_forced = chain_done.get(e.forced_after,
                                                          now)
                            else:
                                t_forced = t
                            send = max(t_last_g, min(t_forced,
                                                     t_open_g + W))
                            if e.retries and fsched is not None:
                                # The recorded close message was dropped
                                # ``retries`` times: each failed attempt
                                # pays the client-side timeout plus
                                # exponential backoff before the
                                # successful send departs.
                                send += fsched.retry_delay(e.retries)
                        if is_async and heap is not None:
                            # Bounded send credit: with K flushes
                            # unacked, the next send (and the chain,
                            # parked at the flush slot) waits for the
                            # oldest outstanding ack.
                            while len(heap) >= ack_K:
                                ready = heapq.heappop(heap)
                                if ready > t:
                                    ack_wait += ready - t
                                    t = ready
                                if ready > send:
                                    send = ready
                        send += hw.batch_flush_lat
                        arrive = send + hw.rpc_net_lat
                        if dep_ready is not None:
                            if gi == 0:
                                dep_wait = max(0.0, dep_ready - arrive)
                            arrive = max(arrive, dep_ready)
                        done = service(e.shard, arrive,
                                       sum(mranges[lo:hi]),
                                       failover=bool(e.failover))
                        effect = done
                        resp = done + hw.rpc_net_lat
                        sends.append(send - hw.batch_flush_lat)
                        rpc_msgs += 1
                        if is_async and heap is not None:
                            heapq.heappush(heap, resp)
                    if e.retries:
                        # Failed attempts are real wire traffic.
                        rpc_msgs += e.retries
                        rpc_retries += e.retries
                    # The chain only blocks if it reaches the flush slot
                    # before the response is back: an early
                    # (timer-fired) flush overlaps client work — and a
                    # fire-and-forget flush does not block on its
                    # response at all.
                    start = sends[0] if sends else t
                    if not is_async:
                        if ack_K > 0:
                            # A sync-class flush drains the window — on
                            # every connection of the client.
                            t = drain_acks(c, t)
                        t = max(t, resp)
                    if flush_trace is not None:
                        flush_trace.append(FlushTrace(
                            event=e, phase=name, opened=mt[0],
                            last_member=mt[-1],
                            chain_arrival=chain_arrival,
                            send=start, dep_wait=dep_wait,
                            response=resp, splits=len(sends),
                            sends=tuple(sends), blocking=not is_async,
                            ack_wait=ack_wait,
                        ))
                    if e.seq in referenced:
                        effect_done[e.seq] = effect
                elif k is EventKind.RPC:
                    rpc_count += 1
                    rpc_msgs += 1
                    # Unqueued RPC (batch=0 or a non-batchable type):
                    # the round trip starts at the client's clock,
                    # exactly the pre-batching model.  A blocking call
                    # is a sync point: outstanding fire-and-forget acks
                    # drain first (no-op at ack_window=0).
                    t2 = drain_acks(c, t)
                    if t2 > t:
                        t = t2
                        start = t
                    send = t
                    if e.retries and fsched is not None:
                        # Dropped ``retries`` times before succeeding:
                        # timeout + exponential backoff per attempt.
                        send += fsched.retry_delay(e.retries)
                    if e.retries:
                        rpc_msgs += e.retries
                        rpc_retries += e.retries
                    arrive = send + hw.rpc_net_lat
                    if honor_edges and e.deps:
                        arrive = max(arrive,
                                     max(effect_done.get(d, now)
                                         for d in e.deps))
                    done = service(e.shard, arrive, e.rpc_ranges,
                                   failover=bool(e.failover))
                    t = done + hw.rpc_net_lat  # response to client
                    if e.seq in referenced:
                        effect_done[e.seq] = done
                bytes_by_kind[k] = bytes_by_kind.get(k, 0) + nb
                if e.seq in referenced:
                    chain_done[e.seq] = t
                    if e.kind is not EventKind.RPC:
                        effect_done[e.seq] = t
                if trace is not None:
                    trace.append((e, start, t))
                if record_order is not None:
                    record_order.append(e.seq)
                clock[c] = t

            if exec_order is None:
                # Event-driven schedule: the client with the smallest
                # clock executes next.  Cross-client edges: seqs
                # scheduled in this phase but not yet executed park
                # their consumers in a waiter table.  Edges always point
                # to strictly smaller seqs and chains execute in seq
                # order, so the wait graph is acyclic (no deadlock).
                heap: List[Tuple[float, int]] = [(now, c) for c in chains]
                heapq.heapify(heap)
                pending: Set[int] = {e.seq for e in events}
                waiters: Dict[int, List[int]] = {}
                while heap:
                    _t, c = heapq.heappop(heap)
                    if idx[c] >= len(chains[c]):
                        continue
                    e = chains[c][idx[c]]
                    if honor_edges and (e.deps or e.forced_after >= 0):
                        anchors = (e.forced_after, *e.deps)
                        blocked = next(
                            (d for d in anchors if d >= 0 and d in pending),
                            None,
                        )
                        if blocked is not None:
                            waiters.setdefault(blocked, []).append(c)
                            continue
                    idx[c] += 1
                    execute(e)
                    pending.discard(e.seq)
                    released = waiters.pop(e.seq, None)
                    if released:
                        for w in released:
                            heapq.heappush(heap, (clock[w], w))
                    if idx[c] < len(chains[c]):
                        heapq.heappush(heap, (clock[c], c))
            else:
                # Forced-order replay (counterfactual pricing): execute
                # this phase's events in the recorded sequence, so every
                # resource is reserved in the same order as the run that
                # produced it and timing differences come only from the
                # toggled cost terms (e.g. ``honor_edges=False``).
                by_seq = {e.seq: e for e in events}
                taken = 0
                while taken < len(events) and op_ptr < len(exec_order):
                    e = by_seq[exec_order[op_ptr]]
                    op_ptr += 1
                    execute(e)
                    taken += 1

            end = max(clock.values(), default=now)
            if ack_K > 0:
                # A phase barrier quiesces the RPC plane: outstanding
                # fire-and-forget acks extend the phase end and are
                # acked before the next phase starts.
                for conns in unacked.values():
                    for pend in conns.values():
                        if pend:
                            end = max(end, max(pend))
                            pend.clear()
            results.append(
                PhaseResult(
                    name=name,
                    duration=end - now,
                    bytes_by_kind=bytes_by_kind,
                    rpc_count=rpc_count,
                    clients=len(chains),
                    rpc_msgs=rpc_msgs,
                    rpc_retries=rpc_retries,
                    failovers=failover_acc[0] - failover0,
                    degraded_time=degraded_acc[0] - degraded0,
                )
            )
            now = end  # global barrier
        return ReplayResult(results, engine="scalar",
                            fallback_reason=fallback_reason)

    # Convenience: one phase by name.
    def phase(self, ledger: EventLedger, name: str) -> PhaseResult:
        for r in self.replay(ledger):
            if r.name == name:
                return r
        raise KeyError(name)

"""Vectorized struct-of-arrays DES replay engine (bitwise scalar-equal).

:meth:`repro_torch.core.costmodel.CostModel.replay` is the repo's pricing
oracle: a per-event Python loop over :class:`~repro_torch.core.basefs.Event`
dataclasses.  At fig7's 2048-client row it is already execution-bound
(~0.7 s, ``BENCH_pr5.json``) and "millions of users" (ROADMAP direction
1) needs orders of magnitude more.  This module is the struct-of-arrays
rework: ``CostModel.replay(engine="vector")`` routes here and MUST
return bitwise-identical :class:`~repro_torch.core.costmodel.PhaseResult`
durations and ``rpc_msgs`` — the golden-equivalence contract specified
in ``docs/REPLAY.md`` and pinned by ``tests/test_vecreplay.py``.

Why this shape (and not a jax scan)
-----------------------------------
The DES schedule is data-dependent: the client with the smallest clock
executes next, FIFO resources couple otherwise-independent chains, and
cross-client ``Event.deps`` edges park consumers in a waiter table.
That serial greedy order is *load-bearing* — resource reservation order
changes timings — so the event loop itself cannot be data-parallelized
without changing results.  What CAN be hoisted out of the loop is
everything per-event that does not depend on the schedule:

* **Lowering** (:func:`lower`): per-attribute list-comprehension
  extraction turns the ledger's
  array-of-structs (``Event`` objects) into parallel numpy columns —
  kind, client, node, shard, nbytes, nranges, linger, flush class,
  anchors, plus CSR-packed ``deps`` and ``members`` — cached on the
  ledger and invalidated by :meth:`EventLedger.clear`.
* **Cost columns** (:meth:`LoweredLedger.costs`): per-event device
  occupancies and chain latencies are computed as vectorized float64
  passes over the columns (IEEE-identical to the scalar per-event
  arithmetic, which is what makes bitwise equality possible), memoized
  per :class:`HardwareConstants`.
* **Resource flattening**: the scalar engine's dict-of-``_Resource``
  tables become one flat availability list indexed by precomputed
  dense ids (ssd/nic/mem planes per node, the PFS, per-shard masters),
  plus per-shard worker arrays.
* **Segmented per-phase accounting**: ``bytes_by_kind``, ``rpc_count``
  and the per-phase client count are segmented ``np.bincount``/
  ``np.unique`` reductions over the marker-delimited column slices —
  they never depend on the schedule.

The remaining scheduling loop operates on plain Python lists of floats
and ints (faster than numpy scalar indexing for serial access), with an
exactness-preserving fast path: when the just-executed client is still
strictly first in ``(clock, client)`` order it continues directly
instead of round-tripping the heap — the pop it skips is exactly the
entry it would have pushed.

Unsupported inputs
------------------
Diagnostics (``trace``/``flush_trace``/``record_order``/``exec_order``/
``record_splits``/``exec_splits``) stay scalar-only — the scalar engine
is the reference oracle and the only consumer of those hooks.  Ledgers
whose event seqs are not contiguous (hand-built ledgers that bypass
:meth:`EventLedger.record`) raise :class:`UnsupportedLedger`;
``CostModel.replay(engine="vector")`` falls back to the scalar engine
for them (documented in ``docs/REPLAY.md``).  Fault-stamped ledgers
(``ledger.faults`` set, :mod:`repro_torch.core.faults`) likewise raise
:class:`UnsupportedLedger` and take the scalar fallback — vectorizing
retry/failover pricing is follow-up work; the contract section "faults
and the replay contract" in ``docs/REPLAY.md`` pins this.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.basefs import (RPC_FENCE_MARKER, SYNC_FLUSH, EventKind,
                                     EventLedger)

__all__ = ["LoweredLedger", "UnsupportedLedger", "lower", "lowered_for",
           "replay_vectorized"]


class UnsupportedLedger(ValueError):
    """The ledger cannot be lowered (non-contiguous event seqs, or a
    fault-stamped ledger — retry/failover pricing is scalar-only)."""


# Kind codes (column encoding of EventKind).
_K_SSD_W, _K_SSD_R, _K_NET, _K_MEM_W, _K_MEM_R = 0, 1, 2, 3, 4
_K_PFS_W, _K_PFS_R, _K_RPC, _K_MARKER = 5, 6, 7, 8
_KIND_CODE = {
    EventKind.SSD_WRITE: _K_SSD_W, EventKind.SSD_READ: _K_SSD_R,
    EventKind.NET_TRANSFER: _K_NET, EventKind.MEM_WRITE: _K_MEM_W,
    EventKind.MEM_READ: _K_MEM_R, EventKind.PFS_WRITE: _K_PFS_W,
    EventKind.PFS_READ: _K_PFS_R, EventKind.RPC: _K_RPC,
    EventKind.MARKER: _K_MARKER,
}
_KIND_CODE_ID = {id(k): c for k, c in _KIND_CODE.items()}
# Row-store ledgers encode the kind cell as ``EventKind.value`` (an
# interned str — keeps row tuples GC-untracked); decode those directly.
_KIND_CODE_VAL = {k.value: c for k, c in _KIND_CODE.items()}
_KIND_BY_CODE = [
    EventKind.SSD_WRITE, EventKind.SSD_READ, EventKind.NET_TRANSFER,
    EventKind.MEM_WRITE, EventKind.MEM_READ, EventKind.PFS_WRITE,
    EventKind.PFS_READ, EventKind.RPC, EventKind.MARKER,
]

# Opcodes driving the scheduling loop (what to do, with which dense
# resource ids; the *cost* lives in the per-hw columns).
_OP_SINGLE = 0   # one FIFO resource + chain latency (ssd/mem/pfs)
_OP_NET = 1      # owner-side device, then owner NIC (two resources)
_OP_FLUSH = 2    # flushed send-queue batch (virtual-clock pricing)
_OP_UNQ = 3      # unqueued RPC round trip
_OP_FENCE = 4    # client-side ack-drain marker (no server traffic)
_OP_MARKER = 5   # phase boundary (never executed)


@dataclass
class _Costs:
    """Per-hw vectorized cost columns, as plain lists for the loop."""

    dur0: List[float]
    lat0: List[float]
    dur1: List[float]
    lat1: List[float]


@dataclass
class LoweredLedger:
    """Struct-of-arrays form of an :class:`EventLedger` (schedule-free).

    Everything here is derivable from the ledger alone — no hardware
    constants, no schedule.  ``costs(hw)`` adds the per-hw cost columns.
    """

    n: int
    seq0: int
    ack_window: int
    n_avail: int                 # flat resource slots (ssd/nic/mem/pfs/masters)
    n_shards: int                # dense shard count (worker pools)
    # Loop columns (plain lists: serial indexing beats numpy scalars).
    op: List[int]
    r0: List[int]
    r1: List[int]
    si: List[int]
    client: List[int]
    linger: List[float]
    nranges: List[int]
    can_async: List[bool]        # attach flush whose close is not a sync point
    ref: List[bool]              # seq is referenced by an anchor/dep/member
    opened: List[int]
    last: List[int]
    forced: List[int]
    dep_t: List[Optional[Tuple[int, ...]]]      # deps (service-order edges)
    blk_t: List[Optional[Tuple[int, ...]]]      # (forced_after, *deps)
    mindptr: List[int]           # members CSR
    manch: List[int]
    mnr: List[int]
    # Per-phase metadata: (name, i0, i1, bytes_by_kind, rpc_count, clients).
    phases: List[Tuple[str, int, int, Dict[EventKind, int], int, int]]
    _cost_cache: Dict[object, _Costs] = field(default_factory=dict)
    _cost_src: Optional[Tuple[np.ndarray, ...]] = None  # (kc, nb, nr, memflag)

    def costs(self, hw) -> _Costs:
        c = self._cost_cache.get(hw)
        if c is None:
            c = self._cost_cache[hw] = _build_costs(self, hw)
        return c


def _build_costs(L: LoweredLedger, hw) -> _Costs:
    """Vectorized per-event occupancy/latency columns for ``hw``.

    Each element is produced by the SAME two IEEE-754 operations the
    scalar engine performs at event time (divide, then add) — numpy
    elementwise float64 arithmetic is bitwise-identical to Python float
    arithmetic, which is what lets the vector engine reproduce scalar
    durations exactly.
    """
    kc, nb, nr, net_mem = L._cost_src
    n = L.n
    dur0 = np.zeros(n)
    lat0 = np.zeros(n)
    dur1 = np.zeros(n)
    lat1 = np.zeros(n)

    m = kc == _K_SSD_W
    dur0[m] = hw.ssd_write_op + nb[m] / hw.ssd_write_bw
    lat0[m] = hw.ssd_write_lat
    m = kc == _K_SSD_R
    dur0[m] = hw.ssd_read_op + nb[m] / hw.ssd_read_bw
    lat0[m] = hw.ssd_read_lat
    m = (kc == _K_MEM_W) | (kc == _K_MEM_R)
    dur0[m] = hw.mem_op + nb[m] / hw.mem_bw
    lat0[m] = hw.mem_lat
    m = (kc == _K_PFS_W) | (kc == _K_PFS_R)
    dur0[m] = hw.pfs_op + nb[m] / hw.pfs_bw
    lat0[m] = hw.pfs_lat

    is_net = kc == _K_NET
    m = is_net & net_mem           # owner-side memory tier (rpc_type "mem")
    dur0[m] = hw.mem_op + nb[m] / hw.mem_bw
    lat0[m] = hw.mem_lat
    m = is_net & ~net_mem          # owner-side SSD read
    dur0[m] = hw.ssd_read_op + nb[m] / hw.ssd_read_bw
    lat0[m] = hw.ssd_read_lat
    dur1[is_net] = hw.net_op + nb[is_net] / hw.net_bw
    lat1[is_net] = hw.net_lat

    # Unqueued RPCs: the worker task duration is schedule-free; flushed
    # batches compute theirs inline (sub-batch membership is dynamic).
    m = kc == _K_RPC
    dur0[m] = hw.task_service + np.maximum(1, nr[m]) * hw.task_per_range

    return _Costs(dur0.tolist(), lat0.tolist(), dur1.tolist(),
                  lat1.tolist())


def lower(ledger: EventLedger) -> LoweredLedger:
    """Lower a recorded ledger into struct-of-arrays columns."""
    if getattr(ledger, "faults", None) is not None:
        raise UnsupportedLedger(
            "fault-stamped ledgers are priced by the scalar engine only "
            "in this release (retry/failover columns are follow-up work)")
    # Native columnar path: a row-store ledger transposes straight into
    # columns — no per-Event object is ever built.  A ledger whose
    # object view was mutated (authoritative_rows() -> None) and any
    # foreign ledger-like object fall back to object extraction.
    rows_fn = getattr(ledger, "authoritative_rows", None)
    rows = rows_fn() if rows_fn is not None else None
    n = len(rows) if rows is not None else len(ledger.events)
    if n == 0:
        return LoweredLedger(
            n=0, seq0=0, ack_window=getattr(ledger, "ack_window", 0),
            n_avail=1, n_shards=0, op=[], r0=[], r1=[], si=[], client=[],
            linger=[], nranges=[], can_async=[], ref=[], opened=[],
            last=[], forced=[], dep_t=[], blk_t=[], mindptr=[0],
            manch=[], mnr=[], phases=[],
            _cost_src=(np.zeros(0, np.int8), np.zeros(0, np.int64),
                       np.zeros(0, np.int64), np.zeros(0, bool)))

    if rows is not None:
        (kinds, clients, nbytes, rtypes, peers, nranges, shards, _calls,
         flushes, lingers, deps, opened, last, forced, members,
         _retries, _failover) = zip(*rows)
        # Row seqs are contiguous by construction (_seq0 + index).
        seq0 = ledger._seq0
    else:
        # Column extraction: one list comprehension per attribute is ~3x
        # faster than a 14-attribute ``attrgetter`` + ``zip(*...)``
        # (which builds and transposes one 14-tuple per event).
        events = ledger.events
        kinds = [e.kind for e in events]
        clients = [e.client for e in events]
        nbytes = [e.nbytes for e in events]
        rtypes = [e.rpc_type for e in events]
        peers = [e.peer for e in events]
        nranges = [e.rpc_ranges for e in events]
        shards = [e.shard for e in events]
        flushes = [e.flush for e in events]
        lingers = [e.linger for e in events]
        deps = [e.deps for e in events]
        opened = [e.opened_after for e in events]
        last = [e.last_after for e in events]
        forced = [e.forced_after for e in events]
        members = [e.members for e in events]
        seq0 = events[0].seq
        if events[-1].seq - seq0 != n - 1:
            raise UnsupportedLedger(
                "event seqs are not contiguous; the vector engine lowers "
                "record()-built ledgers only (scalar engine handles this "
                "one)")

    if rows is not None:
        # Native rows carry the kind cell as EventKind.value.
        kc = np.fromiter((_KIND_CODE_VAL[v] for v in kinds), np.int8,
                         count=n)
    else:
        # id()-keyed kind codes: EventKind members are singletons, and
        # the C-level int hash beats Enum.__hash__ per-event.
        kc = np.fromiter((_KIND_CODE_ID[id(k)] for k in kinds), np.int8,
                         count=n)
    cl = np.fromiter(clients, np.int64, count=n)
    nb = np.fromiter(nbytes, np.int64, count=n)
    nr = np.fromiter(nranges, np.int64, count=n)
    sh = np.fromiter(shards, np.int64, count=n)
    pe = np.fromiter(peers, np.int64, count=n)
    lg = np.fromiter(lingers, np.float64, count=n)
    op_a = np.fromiter(opened, np.int64, count=n)
    la_a = np.fromiter(last, np.int64, count=n)
    fo_a = np.fromiter(forced, np.int64, count=n)
    rt = np.array(rtypes)
    fl = np.array(flushes)

    # ---- dense node / shard ids -------------------------------------
    node_of = dict(ledger.client_node)
    ucl = np.unique(cl)
    unode = np.fromiter((node_of.get(int(c), int(c)) for c in ucl),
                        np.int64, count=len(ucl))
    ev_node = unode[np.searchsorted(ucl, cl)]
    is_net = kc == _K_NET
    ev_pnode = np.zeros(n, np.int64)
    if is_net.any():
        upe = np.unique(pe[is_net])
        upe_node = np.fromiter(
            (node_of.get(int(c), int(c)) for c in upe),
            np.int64, count=len(upe))
        ev_pnode[is_net] = upe_node[np.searchsorted(upe, pe[is_net])]
        all_nodes = np.unique(np.concatenate([ev_node, ev_pnode[is_net]]))
    else:
        all_nodes = np.unique(ev_node)
    nn = len(all_nodes)
    node_d = np.searchsorted(all_nodes, ev_node)
    pnode_d = np.zeros(n, np.int64)
    if is_net.any():
        pnode_d[is_net] = np.searchsorted(all_nodes, ev_pnode[is_net])

    is_rpc = kc == _K_RPC
    ush = np.unique(sh[is_rpc]) if is_rpc.any() else np.zeros(0, np.int64)
    ns = len(ush)
    si = np.zeros(n, np.int64)
    if ns:
        si[is_rpc] = np.searchsorted(ush, sh[is_rpc])

    # Flat resource layout: [ssd 0..nn) [nic nn..2nn) [mem 2nn..3nn)
    # [pfs = 3nn] [masters 3nn+1 ..].
    r0 = np.zeros(n, np.int64)
    r1 = np.zeros(n, np.int64)
    m = (kc == _K_SSD_W) | (kc == _K_SSD_R)
    r0[m] = node_d[m]
    m = (kc == _K_MEM_W) | (kc == _K_MEM_R)
    r0[m] = 2 * nn + node_d[m]
    m = (kc == _K_PFS_W) | (kc == _K_PFS_R)
    r0[m] = 3 * nn
    net_mem = is_net & (rt == "mem")
    r0[net_mem] = 2 * nn + pnode_d[net_mem]
    m = is_net & (rt != "mem")
    r0[m] = pnode_d[m]
    r1[is_net] = nn + pnode_d[is_net]
    r0[is_rpc] = 3 * nn + 1 + si[is_rpc]

    # Opcode column.  Branch ORDER mirrors the scalar engine: an RPC
    # whose rpc_type is the fence marker is a client-side sync marker
    # regardless of any flush tag.
    op = np.full(n, _OP_SINGLE, np.int8)
    op[is_net] = _OP_NET
    is_fence = is_rpc & (rt == RPC_FENCE_MARKER)
    is_flush = is_rpc & ~is_fence & (fl != "")
    op[is_fence] = _OP_FENCE
    op[is_flush] = _OP_FLUSH
    op[is_rpc & ~is_fence & ~is_flush] = _OP_UNQ
    op[kc == _K_MARKER] = _OP_MARKER
    can_async = is_flush & (rt == "attach") & ~np.isin(fl, SYNC_FLUSH)

    # ---- deps / members CSR + sparse edge tuples --------------------
    dep_t: List[Optional[Tuple[int, ...]]] = [None] * n
    blk_t: List[Optional[Tuple[int, ...]]] = [None] * n
    dlens = np.fromiter(map(len, deps), np.int64, count=n)
    for i in np.nonzero((dlens > 0) | (fo_a >= 0))[0].tolist():
        d = deps[i]
        if d:
            dep_t[i] = d
        blk_t[i] = (forced[i], *d)

    mlens = np.fromiter(map(len, members), np.int64, count=n)
    mindptr = np.zeros(n + 1, np.int64)
    np.cumsum(mlens, out=mindptr[1:])
    mflat = list(itertools.chain.from_iterable(members))
    manch = [a for a, _ in mflat]
    mnr = [r for _, r in mflat]

    # ---- referenced seqs (anchor/dep/member targets) ----------------
    ref = np.zeros(n, bool)
    hi = seq0 + n
    for arr in (op_a, la_a, fo_a):
        v = arr[(arr >= seq0) & (arr < hi)]
        ref[v - seq0] = True
    if mflat:
        ma = np.fromiter(manch, np.int64, count=len(manch))
        v = ma[(ma >= seq0) & (ma < hi)]
        ref[v - seq0] = True
    if dlens.any():
        da = np.fromiter(itertools.chain.from_iterable(deps), np.int64,
                         count=int(dlens.sum()))
        v = da[(da >= seq0) & (da < hi)]
        ref[v - seq0] = True

    # ---- phase table + segmented accounting -------------------------
    countable = (is_rpc & ~is_fence).astype(np.int64)
    nbf = nb.astype(np.float64)
    phases: List[Tuple[str, int, int, Dict[EventKind, int], int, int]] = []
    cur_start, cur_name = 0, "phase0"
    bounds = np.nonzero(kc == _K_MARKER)[0].tolist() + [n]
    for mi in bounds:
        if mi > cur_start:
            sl = slice(cur_start, mi)
            kcs = kc[sl]
            cnts = np.bincount(kcs, minlength=9)
            sums = np.bincount(kcs, weights=nbf[sl], minlength=9)
            bk = {_KIND_BY_CODE[k]: int(sums[k])
                  for k in range(9) if cnts[k]}
            phases.append((cur_name, cur_start, mi, bk,
                           int(countable[sl].sum()),
                           len(np.unique(cl[sl]))))
        if mi < n:
            cur_name = rtypes[mi] or f"phase{len(phases)}"
            cur_start = mi + 1

    return LoweredLedger(
        n=n, seq0=seq0, ack_window=getattr(ledger, "ack_window", 0),
        n_avail=3 * nn + 1 + ns, n_shards=ns,
        op=op.tolist(), r0=r0.tolist(), r1=r1.tolist(), si=si.tolist(),
        client=clients, linger=lingers, nranges=nranges,
        can_async=can_async.tolist(), ref=ref.tolist(),
        opened=opened, last=last, forced=forced,
        dep_t=dep_t, blk_t=blk_t, mindptr=mindptr.tolist(),
        manch=manch, mnr=mnr, phases=phases,
        _cost_src=(kc, nb, nr, net_mem))


def lowered_for(ledger: EventLedger) -> LoweredLedger:
    """Lower ``ledger``, caching on the ledger object.

    The cache key tracks the append-only growth of the ledger (event
    count + last seq + registered clients); :meth:`EventLedger.clear`
    — the only non-append mutation — drops the cache explicitly.
    """
    key_fn = getattr(ledger, "_cache_key", None)
    if key_fn is not None:
        key = key_fn()
    else:
        events = ledger.events
        key = (len(events), len(ledger.client_node),
               events[-1].seq if events else -1)
    cached = getattr(ledger, "_vec_lowered", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    L = lower(ledger)
    ledger._vec_lowered = (key, L)
    return L


def _phase_groups(L: LoweredLedger, i0: int, i1: int,
                  chains: Dict[int, List[int]]) -> List[List[int]]:
    """Partition one phase's clients into independent scheduling groups.

    Union-find over clients and the resources their events touch (device
    planes, the PFS, shard masters — each shard's worker pool and ack
    connection follow its master id), plus within-phase dependency and
    ``forced_after`` edges.  Two clients share a group iff some chain of
    shared FIFO resources or HB edges couples their schedules; disjoint
    groups touch disjoint engine state, so replaying them one after
    another is bitwise-identical to the interleaved single-queue
    schedule (pinned by ``tests/test_vecreplay.py``).
    """
    parent: Dict[object, object] = {}

    def find(x):
        r = x
        while True:
            p = parent.get(r, r)
            if p == r:
                break
            r = p
        while x != r:
            parent[x], x = r, parent[x]
        return r

    op_l, r0_l, r1_l, cl_l, blk_t = L.op, L.r0, L.r1, L.client, L.blk_t
    seq0 = L.seq0
    lo, hi = seq0 + i0, seq0 + i1 - 1
    for i in range(i0, i1):
        o = op_l[i]
        ck = cl_l[i]
        if o <= 3:                   # touches r0 (and r1 for net)
            ra, rb = find(ck), find(("r", r0_l[i]))
            if ra != rb:
                parent[ra] = rb
            if o == 1:
                ra, rb = find(ck), find(("r", r1_l[i]))
                if ra != rb:
                    parent[ra] = rb
        blk = blk_t[i]
        if blk is not None:
            for d in blk:
                if lo <= d <= hi:
                    ra, rb = find(ck), find(cl_l[d - seq0])
                    if ra != rb:
                        parent[ra] = rb
    groups: Dict[object, List[int]] = {}
    for ck in chains:
        groups.setdefault(find(ck), []).append(ck)
    return list(groups.values())


def replay_vectorized(hw, ledger: EventLedger,
                      ack_window: Optional[int] = None,
                      honor_edges: bool = True,
                      lowered: Optional[LoweredLedger] = None,
                      independent_queues: bool = False) -> List:
    """Price the ledger on the vectorized engine.

    Returns the same ``List[PhaseResult]`` as the scalar
    :meth:`CostModel.replay`, with bitwise-identical durations and
    identical ``rpc_msgs``/``rpc_count``/``bytes_by_kind``/``clients``.
    See the module docstring for what is vectorized and why the
    scheduling loop itself stays serial.

    ``independent_queues=True`` replays each phase as independently
    advancing per-group event queues: clients coupled by no shared
    resource (shard master, device plane) and no within-phase HB edge
    run to completion back-to-back instead of interleaving through one
    global ``(clock, client)`` heap.  The result is bitwise-identical
    (see :func:`_phase_groups`); the payoff is locality — each group's
    working set stays hot instead of round-robining across every
    client in the phase.
    """
    from repro_torch.core.costmodel import PhaseResult  # no import cycle: lazy

    L = lowered if lowered is not None else lowered_for(ledger)
    C = L.costs(hw)
    n, seq0 = L.n, L.seq0
    ack_K = L.ack_window if ack_window is None else max(0, ack_window)

    # Mutable engine state (persists across phases, like the scalar's).
    avail = [0.0] * L.n_avail
    nworkers = hw.server_workers
    workers = [[0.0] * nworkers for _ in range(L.n_shards)]
    rr = [0] * L.n_shards
    chain: List[Optional[float]] = [None] * n
    effect: List[Optional[float]] = [None] * n
    done_f = bytearray(n)
    # Per-client, per-connection ack heaps (connection = dense shard id,
    # a per-ledger bijection of the scalar engine's raw ``Event.shard``
    # key — identical partition, bitwise-identical drains).
    unacked: Dict[int, Dict[int, List[float]]] = {}

    # Loop-local bindings.
    op_l, r0_l, r1_l, si_l = L.op, L.r0, L.r1, L.si
    cl_l, lg_l, nr_l = L.client, L.linger, L.nranges
    asy_l, ref_l = L.can_async, L.ref
    opened_l, last_l, forced_l = L.opened, L.last, L.forced
    dep_t, blk_t = L.dep_t, L.blk_t
    mip, manch_l, mnr_l = L.mindptr, L.manch, L.mnr
    dur0_l, lat0_l, dur1_l, lat1_l = C.dur0, C.lat0, C.dur1, C.lat1
    so_ = hw.server_occupancy
    ts_, tpr_ = hw.task_service, hw.task_per_range
    bfl_, rnl_ = hw.batch_flush_lat, hw.rpc_net_lat
    cpush, cpop = heapq.heappush, heapq.heappop

    results: List[PhaseResult] = []
    now = 0.0

    for name, i0, i1, bk, rpc_count, nclients in L.phases:
        chains: Dict[int, List[int]] = {}
        for i in range(i0, i1):
            c = cl_l[i]
            lst = chains.get(c)
            if lst is None:
                chains[c] = [i]
            else:
                lst.append(i)
        clock = dict.fromkeys(chains, now)
        idx = dict.fromkeys(chains, 0)
        lo_seq, hi_seq = seq0 + i0, seq0 + i1 - 1
        groups = (_phase_groups(L, i0, i1, chains) if independent_queues
                  else None)
        gi = 0
        heap: List[Tuple[float, int]] = ([] if groups is not None
                                         else [(now, c) for c in chains])
        heapq.heapify(heap)
        waiters: Dict[int, List[int]] = {}
        rpc_msgs = 0

        c: Optional[int] = None
        while True:
            if c is None:
                if not heap:
                    # Independent-queue mode: drained one group's queue;
                    # start the next group's (disjoint state, so the
                    # switch cannot change any timing).
                    if groups is not None and gi < len(groups):
                        heap = [(now, g) for g in groups[gi]]
                        heapq.heapify(heap)
                        gi += 1
                        continue
                    break
                _t, c = cpop(heap)
                if idx[c] >= len(chains[c]):
                    c = None
                    continue
            ch = chains[c]
            i = ch[idx[c]]
            blk = blk_t[i]
            if honor_edges and blk is not None:
                blocked = -1
                for d in blk:
                    if lo_seq <= d <= hi_seq and not done_f[d - seq0]:
                        blocked = d
                        break
                if blocked >= 0:
                    waiters.setdefault(blocked - seq0, []).append(c)
                    c = None
                    continue
            idx[c] += 1
            t = clock[c]
            o = op_l[i]
            if o == 0:               # single FIFO resource + latency
                r = r0_l[i]
                a = avail[r]
                if a > t:
                    t = a
                t += dur0_l[i]
                avail[r] = t
                t += lat0_l[i]
            elif o == 1:             # net: owner device, then owner NIC
                r = r0_l[i]
                a = avail[r]
                if a > t:
                    t = a
                t += dur0_l[i]
                avail[r] = t
                t += lat0_l[i]
                r = r1_l[i]
                a = avail[r]
                if a > t:
                    t = a
                t += dur1_l[i]
                avail[r] = t
                t += lat1_l[i]
            elif o == 2:             # flushed send-queue batch
                W = lg_l[i]
                ms, me = mip[i], mip[i + 1]
                if me > ms:          # per-member anchors: reconstruct
                    mt: List[float] = []
                    ap = mt.append
                    for a_ in manch_l[ms:me]:
                        ja = a_ - seq0
                        if 0 <= ja < n:
                            v = chain[ja]
                            if v is None or v < now:
                                v = now
                        else:
                            v = now
                        ap(v)
                    mr = mnr_l[ms:me]
                    nm = len(mt)
                    bounds_l: List[int] = []
                    open_t = mt[0]
                    for g in range(1, nm):
                        v = mt[g]
                        if v > open_t + W:
                            bounds_l.append(g)
                            open_t = v
                else:                # aggregate-anchor fallback: 1 msg
                    ja = opened_l[i] - seq0
                    if 0 <= ja < n:
                        v = chain[ja]
                        t_open = now if v is None or v < now else v
                    else:
                        t_open = now
                    jb = last_l[i] - seq0
                    if 0 <= jb < n:
                        v = chain[jb]
                        vlast = now if v is None else v
                    else:
                        vlast = now
                    mt = [t_open, t_open if t_open > vlast else vlast]
                    nrv = nr_l[i]
                    mr = [0, nrv if nrv > 1 else 1]
                    nm = 2
                    bounds_l = []
                is_async = ack_K > 0 and asy_l[i]
                heap_c = None
                if ack_K > 0:
                    conns = unacked.get(c)
                    if conns is None:
                        conns = unacked[c] = {}
                    s_key = si_l[i]
                    heap_c = conns.get(s_key)
                    if heap_c is None:
                        heap_c = conns[s_key] = []
                dep_ready = None
                dpt = dep_t[i]
                if honor_edges and dpt is not None:
                    best = now
                    for d in dpt:
                        jd = d - seq0
                        if 0 <= jd < n:
                            v = effect[jd]
                            if v is not None and v > best:
                                best = v
                    dep_ready = best
                effect_v = now
                resp = now
                gstart = 0
                for gend in bounds_l + [nm]:
                    t_open_g = mt[gstart]
                    t_last_g = mt[gend - 1]
                    if gend < nm:    # timer split: departs on its window
                        send = t_open_g + W
                        if t_last_g > send:
                            send = t_last_g
                    else:            # final sub-batch: recorded close
                        fo = forced_l[i]
                        if fo >= 0:
                            jf = fo - seq0
                            tf = chain[jf] if 0 <= jf < n else None
                            if tf is None:
                                tf = now
                        else:
                            tf = t
                        ow = t_open_g + W
                        m_ = tf if tf < ow else ow
                        send = t_last_g if t_last_g > m_ else m_
                    if is_async:
                        while len(heap_c) >= ack_K:
                            ready = cpop(heap_c)
                            if ready > t:
                                t = ready
                            if ready > send:
                                send = ready
                    send += bfl_
                    arrive = send + rnl_
                    if dep_ready is not None and dep_ready > arrive:
                        arrive = dep_ready
                    nrg = sum(mr[gstart:gend])
                    if nrg < 1:
                        nrg = 1
                    r = r0_l[i]          # shard master
                    a = avail[r]
                    if a < arrive:
                        a = arrive
                    a += so_
                    avail[r] = a
                    s_ = si_l[i]         # round-robin worker
                    w = workers[s_]
                    k_ = rr[s_]
                    wa = w[k_]
                    if wa < a:
                        wa = a
                    wa += ts_ + nrg * tpr_
                    w[k_] = wa
                    k_ += 1
                    rr[s_] = 0 if k_ == nworkers else k_
                    effect_v = wa
                    resp = wa + rnl_
                    rpc_msgs += 1
                    if is_async:
                        cpush(heap_c, resp)
                    gstart = gend
                if not is_async:
                    if ack_K > 0:    # sync-class flush drains EVERY
                        conns = unacked.get(c)   # connection's window
                        if conns:
                            for pend in conns.values():
                                if pend:
                                    mh = max(pend)
                                    if mh > t:
                                        t = mh
                                    pend.clear()
                    if resp > t:
                        t = resp
                if ref_l[i]:
                    effect[i] = effect_v
            elif o == 3:             # unqueued RPC round trip
                conns = unacked.get(c)
                if conns:
                    for pend in conns.values():
                        if pend:
                            mp = max(pend)
                            if mp > t:
                                t = mp
                            pend.clear()
                arrive = t + rnl_
                dpt = dep_t[i]
                if honor_edges and dpt is not None:
                    best = now
                    for d in dpt:
                        jd = d - seq0
                        if 0 <= jd < n:
                            v = effect[jd]
                            if v is not None and v > best:
                                best = v
                    if best > arrive:
                        arrive = best
                r = r0_l[i]
                a = avail[r]
                if a < arrive:
                    a = arrive
                a += so_
                avail[r] = a
                s_ = si_l[i]
                w = workers[s_]
                k_ = rr[s_]
                wa = w[k_]
                if wa < a:
                    wa = a
                wa += dur0_l[i]      # precomputed worker task duration
                w[k_] = wa
                k_ += 1
                rr[s_] = 0 if k_ == nworkers else k_
                t = wa + rnl_
                rpc_msgs += 1
                if ref_l[i]:
                    effect[i] = wa
            else:                    # o == 4: client-side fence marker
                conns = unacked.get(c)
                if conns:
                    for pend in conns.values():
                        if pend:
                            mp = max(pend)
                            if mp > t:
                                t = mp
                            pend.clear()
            done_f[i] = 1
            if ref_l[i]:
                chain[i] = t
                if o <= 1:           # non-RPC kinds: effect == chain
                    effect[i] = t
            clock[c] = t
            rel = waiters.pop(i, None)
            if rel:
                for w_ in rel:
                    cpush(heap, (clock[w_], w_))
            if idx[c] < len(ch):
                if heap:
                    ht, hc = heap[0]
                    if t > ht or (t == ht and c > hc):
                        cpush(heap, (t, c))
                        c = None
                # else: still strictly first — continue directly (the
                # push/pop pair this skips would return exactly (t, c)).
            else:
                c = None

        end = now
        for v in clock.values():
            if v > end:
                end = v
        if ack_K > 0:
            for conns in unacked.values():
                for pend in conns.values():
                    if pend:
                        mp = max(pend)
                        if mp > end:
                            end = mp
                        pend.clear()
        results.append(PhaseResult(
            name=name, duration=end - now, bytes_by_kind=dict(bk),
            rpc_count=rpc_count, clients=nclients, rpc_msgs=rpc_msgs))
        now = end
    return results

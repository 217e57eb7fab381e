"""Seeded fault-injection plane for the BaseFS DES (docs/FAULTS.md).

The paper's checkpoint/restart workloads exist *because* large systems
fail, yet the base DES models a fault-free world.  This module injects
failures **deterministically**: a frozen :class:`FaultSchedule` (the
seeded configuration) plus a mutable :class:`FaultState` (one run's
counters), wired in via ``BaseFS(faults=schedule)``.

Design: execution-time stamping, replay-time pricing
----------------------------------------------------
Faults are decided at *execution* time — when an RPC event is recorded,
the fault state draws its retry count from a counter-keyed hash of the
schedule seed and advances the per-shard crash countdown — and stamped
on the event (``Event.retries`` / ``Event.failover``).  The ledger is
therefore bit-for-bit deterministic per seed (pinned by the
fault-schedule determinism tests), and the scalar replay engine prices
the stamps afterwards:

* **drop/timeout → retry** — each recorded wire message is dropped
  ``Event.retries`` times before succeeding; the client-side link layer
  waits ``rpc_timeout`` per failed attempt plus exponential backoff
  (``backoff_base * 2**attempt``), so the successful send departs
  ``retry_delay(retries)`` later and every failed attempt still counts
  as a wire message (``rpc_msgs``; retries are never free).
* **shard-master crash/failover** — shard ``s`` crashes when its
  ``crash_shards[s]``-th RPC message is recorded.  The replay prices a
  ``recovery_window`` blackout at that shard's master (failover to the
  standby), and the execution layer replays every un-fenced
  fire-and-forget attach batch that was in flight to the failed master
  at the issuing client's next fence (see ``RPCBatcher`` in
  :mod:`repro_torch.core.basefs`) — unless ``lossy=True``, the negative
  control where the in-flight batches are silently dropped and the
  tracer refuses to count the corresponding consistency fence
  (:mod:`repro_torch.analysis.trace`), so the race checker can witness the
  broken recovery.
* **slow shard (degraded service)** — ``slow_shards`` multiplies a
  shard's master/worker service times; the excess is accounted as
  ``PhaseResult.degraded_time``.
* **node loss (SCR)** — ``lost_nodes`` names nodes that die before a
  restart (their burst buffers AND ranks are gone — the fig5 scenario),
  ``buffer_loss_nodes`` names nodes whose ranks survive but whose
  burst-buffer copy is lost (restart must read the partner copy).

``faults=None`` everywhere is the fault-free model and replays
bitwise-identical to the fault-free goldens — every fault branch in
recording and pricing is gated on the schedule being present.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Tuple, Union

__all__ = ["FaultSchedule", "FaultState", "LostBatch"]

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: deterministic, platform-independent."""
    x &= _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _u01(seed: int, msg: int, attempt: int) -> float:
    """Uniform [0, 1) draw keyed by (seed, message index, attempt)."""
    h = _mix64(_mix64(seed ^ 0x9E3779B97F4A7C15) + 0x632BE59BD9B4E019 * msg
               + 0xD1B54A32D192ED03 * attempt)
    return h / float(1 << 64)


def _as_items(value: Union[Mapping, Tuple, List]) -> Tuple:
    """Normalize a mapping or pair sequence into a sorted item tuple
    (frozen dataclass fields must be hashable)."""
    if isinstance(value, Mapping):
        return tuple(sorted(value.items()))
    return tuple(sorted(tuple(v) for v in value))


@dataclass(frozen=True)
class LostBatch:
    """One in-flight attach batch dropped by a lossy failover."""

    client: int
    shard: int
    nbytes: int
    nranges: int


@dataclass(frozen=True)
class FaultSchedule:
    """Seeded, deterministic fault configuration (hashable, reusable).

    Pass to ``BaseFS(faults=...)`` (execution-time stamping) and — by
    default via the ledger — to ``CostModel.replay(faults=...)``
    (pricing).  ``crash_shards``/``slow_shards`` accept mappings or
    ``(key, value)`` pair sequences; they are normalized to sorted
    tuples so the schedule stays hashable.
    """

    seed: int = 0
    #: Per-wire-message drop/timeout probability in [0, 1).
    drop_rate: float = 0.0
    #: Cap on retransmissions per message (the k-th retry succeeds).
    max_retries: int = 4
    #: Client-side timeout before each retransmission (s).
    rpc_timeout: float = 200e-6
    #: Exponential backoff before retry k: ``backoff_base * 2**k`` (s).
    backoff_base: float = 50e-6
    #: ``shard -> N``: the shard master crashes when its N-th RPC
    #: message is recorded (execution order; deterministic).
    crash_shards: Tuple[Tuple[int, int], ...] = ()
    #: Failover blackout priced at the crashed shard's master (s).
    recovery_window: float = 2e-3
    #: ``shard -> multiplier > 1``: degraded-service straggler shards.
    slow_shards: Tuple[Tuple[int, float], ...] = ()
    #: Negative control: failover DROPS in-flight attach batches
    #: instead of replaying them (see docs/FAULTS.md).
    lossy: bool = False
    #: SCR: nodes that die before restart (ranks + burst buffer lost).
    lost_nodes: Tuple[int, ...] = ()
    #: SCR: surviving nodes whose burst-buffer copy is lost before
    #: restart (ranks must re-read the partner copy).
    buffer_loss_nodes: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "crash_shards",
                           _as_items(self.crash_shards))
        object.__setattr__(self, "slow_shards",
                           _as_items(self.slow_shards))
        object.__setattr__(self, "lost_nodes", tuple(self.lost_nodes))
        object.__setattr__(self, "buffer_loss_nodes",
                           tuple(self.buffer_loss_nodes))
        if not 0.0 <= self.drop_rate < 1.0:
            raise ValueError(f"drop_rate must be in [0, 1), got "
                             f"{self.drop_rate}")

    def start(self) -> "FaultState":
        """Fresh mutable run state for one BaseFS execution."""
        return FaultState(self)

    def retry_delay(self, retries: int) -> float:
        """Client-visible delay of ``retries`` failed attempts (s):
        per attempt, the timeout plus the exponential backoff."""
        d = 0.0
        for k in range(retries):
            d += self.rpc_timeout + self.backoff_base * (2.0 ** k)
        return d


@dataclass
class FaultState:
    """One run's mutable fault counters (created by ``start()``).

    ``BaseFS`` attaches this to the ledger (``ledger.faults``) so the
    replay engine finds the pricing schedule by default, the batcher
    finds the crash set at fence time, and the tracer finds the lossy
    losses.  All draws are counter-keyed (message index, attempt) off
    the schedule seed — same seed, same workload ⇒ same stamps.
    """

    schedule: FaultSchedule
    #: ``shard -> per-shard message index at which it crashed``.
    crashed: Dict[int, int] = field(default_factory=dict)
    #: Lossy-mode drops, in loss order (the negative-control witness).
    lost: List[LostBatch] = field(default_factory=list)
    _served: Dict[int, int] = field(default_factory=dict)
    _crash_at: Dict[int, int] = field(default_factory=dict)
    _lost_by_client: Dict[int, int] = field(default_factory=dict)
    _msg: int = 0

    def __post_init__(self) -> None:
        self._crash_at = dict(self.schedule.crash_shards)

    def reset(self) -> None:
        """Restart the counters (``EventLedger.clear`` reuse path)."""
        self.crashed.clear()
        self.lost.clear()
        self._served.clear()
        self._lost_by_client.clear()
        self._crash_at = dict(self.schedule.crash_shards)
        self._msg = 0

    # ---- execution-time stamping (called from EventLedger.record) ----
    def on_rpc(self, rpc_type: str, shard: int) -> Tuple[int, int]:
        """Stamp one recorded RPC: returns ``(retries, failover)``.

        Advances the global message counter (retry draws) and the
        per-shard served counter (crash countdown).  The message that
        trips a shard's crash point carries ``failover=1`` — the replay
        prices the recovery-window blackout at its arrival.
        """
        sched = self.schedule
        n = self._msg
        self._msg = n + 1
        retries = 0
        if sched.drop_rate > 0.0:
            while (retries < sched.max_retries
                   and _u01(sched.seed, n, retries) < sched.drop_rate):
                retries += 1
        served = self._served.get(shard, 0) + 1
        self._served[shard] = served
        failover = 0
        crash_at = self._crash_at.get(shard)
        if (crash_at is not None and served >= crash_at
                and shard not in self.crashed):
            self.crashed[shard] = served
            failover = 1
        return retries, failover

    def is_crashed(self, shard: int) -> bool:
        return shard in self.crashed

    # ---- lossy-recovery bookkeeping ----------------------------------
    def note_lost(self, client: int, shard: int, nbytes: int,
                  nranges: int) -> None:
        """A lossy failover dropped this client's in-flight batch."""
        self.lost.append(LostBatch(client, shard, nbytes, nranges))
        self._lost_by_client[client] = (
            self._lost_by_client.get(client, 0) + 1)

    def lost_count(self, client: int) -> int:
        """Batches dropped for ``client`` so far (tracer consult: a
        consistency fence that lost batches must not count formally)."""
        return self._lost_by_client.get(client, 0)

"""Stripe-to-shard routing for the sharded metadata service.

The metadata of one file is striped over the server shards: byte range
``[k*stripe, (k+1)*stripe)`` routes to shard ``(crc32(path) + k) % N``.
:class:`StaticRouter` implements exactly that fixed layout (the original
behaviour: 64 KiB stripes, crc32 round-robin).  :class:`AdaptiveRouter`
adds the ROADMAP's two follow-ups:

* **adaptive stripe width** — per file, the stripe width tracks an EWMA
  of the observed access sizes (clamped to powers of two in
  [:data:`MIN_STRIPE`, :data:`MAX_STRIPE`]), so a file accessed in 8 MB
  runs is not shredded into 128 stripe pieces per access while 8 KB
  accesses still spread over all shards;
* **shard rebalancing under skewed offsets** — per-stripe load counters
  detect when one shard serves a disproportionate share of the range
  descriptors (e.g. every client hammering one hot 64 KiB region) and
  move the hottest stripes to the least-loaded shard via an explicit
  override table.

Both adaptations change the *layout*, so the owning
:class:`~repro_torch.core.basefs.GlobalServer` must migrate the affected
files' interval trees between shard trees when the router reports them
dirty (``take_dirty``); the server records the migration as ``migrate``
RPCs, dep-anchored (``Event.deps``) on the access that triggered the
re-layout, so the DES both prices the rebalancing traffic and schedules
it on the simulation's virtual clock — a migration cannot execute at
phase start when its trigger happened mid-phase.  Routing stays
deterministic: given the same observation sequence, the same layout
decisions are made (no wall-clock, no ``hash()`` randomisation).
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Set, Tuple

#: Default metadata stripe width: 64 KiB keeps the paper's 8 KB accesses
#: single-shard while spreading them uniformly over shards.
DEFAULT_STRIPE = 64 * 1024

#: Adaptive stripe bounds (powers of two).
MIN_STRIPE = 8 * 1024
MAX_STRIPE = 8 * 1024 * 1024

#: Re-evaluate a file's stripe width every this many observed accesses.
ADAPT_OPS = 32
#: Consider a rebalance every this many observed stripe pieces (global).
REBALANCE_OPS = 256
#: Trigger a rebalance when max shard load exceeds mean by this factor.
SKEW_THRESHOLD = 2.0
#: Max stripes moved per rebalance round (bounds migration bursts).
MAX_MOVES = 8


def shard_of(path: str, offset: int, num_shards: int,
             stripe: int = DEFAULT_STRIPE) -> int:
    """Deterministic static routing (stable across processes, unlike hash())."""
    if num_shards <= 1:
        return 0
    return (zlib.crc32(path.encode()) + offset // stripe) % num_shards


class StaticRouter:
    """Fixed-width crc32 round-robin layout (the paper-faithful default)."""

    kind = "static"

    def __init__(self, num_shards: int, stripe: int = DEFAULT_STRIPE) -> None:
        self.num_shards = max(1, num_shards)
        self.stripe = stripe

    # ---- layout -------------------------------------------------------
    def width(self, path: str) -> int:
        return self.stripe

    def shard_for(self, path: str, offset: int) -> int:
        if self.num_shards == 1:
            return 0
        return (zlib.crc32(path.encode()) + offset // self.width(path)) \
            % self.num_shards

    def split_runs(
        self, path: str, runs: List[Tuple[int, int]]
    ) -> Dict[int, List[Tuple[int, int]]]:
        """Partition byte runs into per-shard stripe-aligned pieces."""
        if self.num_shards == 1:
            return {0: list(runs)}
        w = self.width(path)
        by_shard: Dict[int, List[Tuple[int, int]]] = {}
        for start, end in runs:
            pos = start
            while pos < end:
                cut = min(end, (pos // w + 1) * w)
                by_shard.setdefault(self.shard_for(path, pos), []).append(
                    (pos, cut)
                )
                pos = cut
        return by_shard

    # ---- adaptivity hooks (no-ops for the static layout) --------------
    def observe(self, path: str, runs: List[Tuple[int, int]],
                by_shard: Dict[int, List[Tuple[int, int]]]) -> None:
        pass

    def take_dirty(self) -> Set[str]:
        """Paths whose layout changed since the last call (need migration)."""
        return set()


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


class AdaptiveRouter(StaticRouter):
    """Size-matched stripe widths + load-driven stripe rebalancing."""

    kind = "adaptive"

    def __init__(self, num_shards: int, stripe: int = DEFAULT_STRIPE) -> None:
        super().__init__(num_shards, stripe)
        self._width: Dict[str, int] = {}
        self._ewma: Dict[str, float] = {}
        self._path_ops: Dict[str, int] = {}
        self._stripe_load: Dict[Tuple[str, int], int] = {}
        self._shard_load: Dict[int, int] = {}
        self._overrides: Dict[Tuple[str, int], int] = {}
        self._global_ops = 0
        self._dirty: Set[str] = set()

    # ---- layout -------------------------------------------------------
    def width(self, path: str) -> int:
        return self._width.get(path, self.stripe)

    def shard_for(self, path: str, offset: int) -> int:
        if self.num_shards == 1:
            return 0
        idx = offset // self.width(path)
        override = self._overrides.get((path, idx))
        if override is not None:
            return override
        return (zlib.crc32(path.encode()) + idx) % self.num_shards

    # ---- observation / adaptation ------------------------------------
    def observe(self, path: str, runs: List[Tuple[int, int]],
                by_shard: Dict[int, List[Tuple[int, int]]]) -> None:
        if self.num_shards == 1:
            # Layout is a no-op on one shard (split_runs never splits):
            # adapting widths would only trigger pointless migrations.
            return
        w = self.width(path)
        for start, end in runs:
            prev = self._ewma.get(path, float(end - start))
            self._ewma[path] = 0.8 * prev + 0.2 * (end - start)
        for k, pieces in by_shard.items():
            self._shard_load[k] = self._shard_load.get(k, 0) + len(pieces)
            for s, _e in pieces:
                key = (path, s // w)
                self._stripe_load[key] = self._stripe_load.get(key, 0) + 1
        self._global_ops += len(runs)
        self._path_ops[path] = self._path_ops.get(path, 0) + len(runs)
        if self._path_ops[path] % ADAPT_OPS == 0:
            self._adapt_width(path)
        if self._global_ops >= REBALANCE_OPS:
            self._global_ops = 0
            self._maybe_rebalance()

    def _adapt_width(self, path: str) -> None:
        target = _pow2_at_least(int(self._ewma.get(path, self.stripe)))
        target = min(max(target, MIN_STRIPE), MAX_STRIPE)
        cur = self.width(path)
        # Hysteresis: re-stripe only on a >= 2x mismatch.
        if target >= 2 * cur or 2 * target <= cur:
            self._width[path] = target
            # Old stripe indices are meaningless under the new width.
            self._stripe_load = {
                k: v for k, v in self._stripe_load.items() if k[0] != path
            }
            self._overrides = {
                k: v for k, v in self._overrides.items() if k[0] != path
            }
            self._dirty.add(path)

    def _maybe_rebalance(self) -> None:
        if not self._shard_load:
            return
        loads = [self._shard_load.get(k, 0) for k in range(self.num_shards)]
        mean = sum(loads) / self.num_shards
        hot = max(range(self.num_shards), key=lambda k: loads[k])
        if mean <= 0 or loads[hot] < SKEW_THRESHOLD * mean:
            return
        cold = min(range(self.num_shards), key=lambda k: loads[k])
        # Hottest stripes currently routed to the hot shard, by load.
        candidates = sorted(
            (
                (load, key)
                for key, load in self._stripe_load.items()
                if self.shard_for(key[0], key[1] * self.width(key[0])) == hot
            ),
            reverse=True,
        )
        to_move = max(0, int(loads[hot] - mean))
        moved = 0
        for load, key in candidates[:MAX_MOVES]:
            if moved >= to_move:
                break
            self._overrides[key] = cold
            self._dirty.add(key[0])
            moved += load
        # Decay counters so the next window reflects post-move traffic.
        self._shard_load = {k: v // 2 for k, v in self._shard_load.items()}
        self._stripe_load = {k: v // 2 for k, v in self._stripe_load.items()}

    def take_dirty(self) -> Set[str]:
        dirty, self._dirty = self._dirty, set()
        return dirty


def make_router(num_shards: int, stripe: int = DEFAULT_STRIPE,
                adaptive: bool = False) -> StaticRouter:
    cls = AdaptiveRouter if adaptive else StaticRouter
    return cls(num_shards, stripe)

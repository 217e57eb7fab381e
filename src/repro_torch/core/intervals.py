"""Interval maps for BaseFS (paper §5.1.2).

The paper uses augmented self-balancing BSTs; we implement the same semantics
with a sorted list of disjoint intervals + bisect (O(log n) search, O(k)
splice for the k intervals touched by an update).  Two variants:

* ``OwnerIntervalMap`` — the *global* interval tree kept by the BaseFS server:
  disjoint ``[start, end) -> owner`` ranges, where an attach by a new owner
  splits/deletes existing intervals and contiguous same-owner intervals merge.

* ``BufferIntervalMap`` — the *local* interval tree kept by each client:
  disjoint ``[start, end) -> (buf_offset, attached)`` ranges mapping file
  ranges to positions in the node-local burst-buffer file.

All ranges are half-open ``[start, end)`` with ``0 <= start < end``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Tuple


@dataclass(frozen=True)
class Interval:
    """A disjoint interval with an arbitrary payload (owner id, buffer slot...)."""

    start: int
    end: int  # exclusive
    value: Any

    def __post_init__(self) -> None:
        if not (0 <= self.start < self.end):
            raise ValueError(f"bad interval [{self.start}, {self.end})")

    @property
    def length(self) -> int:
        return self.end - self.start

    def overlaps(self, start: int, end: int) -> bool:
        return self.start < end and start < self.end


class IntervalMap:
    """Disjoint interval map with split/merge semantics (paper §5.1.2).

    ``insert`` implements the server's attach rule: an existing interval is
    *split* if it partially overlaps the new one, *deleted* if fully covered,
    and contiguous intervals with equal values are *merged*.
    """

    def __init__(self, merge_values: bool = True):
        self._starts: List[int] = []
        self._ends: List[int] = []
        self._ivals: List[Interval] = []
        self._merge = merge_values

    # ------------------------------------------------------------------ util
    def __len__(self) -> int:
        return len(self._ivals)

    def __iter__(self) -> Iterator[Interval]:
        return iter(self._ivals)

    def _first_overlap_idx(self, start: int, end: int) -> int:
        """Index of the first stored interval with .end > start (candidate)."""
        # Disjointness makes _ends strictly increasing alongside _starts, so
        # the sorted-endpoint index answers "first interval ending after
        # ``start``" in O(log n) — no linear scan even for 1000+-client maps.
        return bisect.bisect_right(self._ends, start)

    # --------------------------------------------------------------- queries
    def query(self, start: int, end: int) -> List[Interval]:
        """All stored intervals overlapping [start, end), clipped to the range."""
        if end <= start:
            return []
        out: List[Interval] = []
        i = self._first_overlap_idx(start, end)
        while i < len(self._ivals) and self._ivals[i].start < end:
            iv = self._ivals[i]
            if iv.overlaps(start, end):
                out.append(
                    Interval(max(iv.start, start), min(iv.end, end), iv.value)
                )
            i += 1
        return out

    def covers(self, start: int, end: int) -> bool:
        """True iff [start, end) is fully covered by stored intervals."""
        pos = start
        for iv in self.query(start, end):
            if iv.start > pos:
                return False
            pos = max(pos, iv.end)
        return pos >= end

    def sole_cover(self, start: int, end: int) -> Optional[Interval]:
        """The single stored interval covering ALL of [start, end), or None.

        One bisect, no clipping, no list: the bulk read kernel's fast
        path (a read fully inside one owner's range — the common case
        for block-aligned workloads) resolves with this instead of
        ``query`` + ``covers``.  ``None`` means "not covered by one
        interval" — multi-interval coverage and gaps both fall back to
        the general query path, so this is an accelerator, never an
        answer-changer.
        """
        i = bisect.bisect_right(self._ends, start)
        if i < len(self._ivals):
            iv = self._ivals[i]
            if iv.start <= start and end <= iv.end:
                return iv
        return None

    def gaps(self, start: int, end: int) -> List[Tuple[int, int]]:
        """Sub-ranges of [start, end) not covered by any interval."""
        out: List[Tuple[int, int]] = []
        pos = start
        for iv in self.query(start, end):
            if iv.start > pos:
                out.append((pos, iv.start))
            pos = max(pos, iv.end)
        if pos < end:
            out.append((pos, end))
        return out

    # --------------------------------------------------------------- updates
    def _shift_value(self, value: Any, delta: int) -> Any:
        """Adjust a payload when its interval's start moves by ``delta``.

        Plain values (owner ids) are position-independent; BufferIntervalMap
        overrides this to keep buffer offsets aligned with file offsets.
        """
        return value

    def insert(self, start: int, end: int, value: Any) -> None:
        """Insert [start, end) -> value, splitting/overwriting overlaps."""
        if end <= start:
            raise ValueError("empty insert")
        i = self._first_overlap_idx(start, end)
        ivals = self._ivals
        if i == len(ivals) or ivals[i].start >= end:
            # Nothing overlapped: one positional insert, no splice
            # machinery.  The attach stream of a bulk commit tail is
            # ascending, so this is usually an O(1) append.
            ivals.insert(i, Interval(start, end, value))
            self._starts.insert(i, start)
            self._ends.insert(i, end)
            if self._merge:
                self._merge_around(i, i + 1)
            return
        new_pieces: List[Interval] = []
        # Remove every overlapped interval, keeping the uncovered flanks.
        j = i
        while j < len(self._ivals) and self._ivals[j].start < end:
            iv = self._ivals[j]
            if iv.overlaps(start, end):
                if iv.start < start:  # left flank survives (split)
                    new_pieces.append(Interval(iv.start, start, iv.value))
                if iv.end > end:  # right flank survives (split)
                    new_pieces.append(
                        Interval(
                            end, iv.end,
                            self._shift_value(iv.value, end - iv.start),
                        )
                    )
            else:
                new_pieces.append(iv)
            j += 1
        new_pieces.append(Interval(start, end, value))
        new_pieces.sort(key=lambda v: v.start)
        self._ivals[i:j] = new_pieces
        self._starts[i:j] = [iv.start for iv in new_pieces]
        self._ends[i:j] = [iv.end for iv in new_pieces]
        if self._merge:
            self._merge_around(i, i + len(new_pieces))

    def insert_run(self, runs: List[Tuple[int, int]], value: Any) -> None:
        """Insert several ascending, non-overlapping ``[start, end)`` ->
        ``value`` pieces with ONE windowed list splice.

        Semantically identical to calling :meth:`insert` per piece
        (property-tested), but the three sorted lists are spliced once
        over the whole affected window instead of once per piece — the
        server's attach path at thousands of clients was O(pieces x
        tree) in list splices alone.  Pieces that are not ascending and
        disjoint fall back to per-piece inserts.
        """
        if not runs:
            return
        if len(runs) == 1 or any(
            a_end > b_start for (_a, a_end), (b_start, _b)
            in zip(runs, runs[1:])
        ):
            for start, end in runs:
                self.insert(start, end, value)
            return
        if runs[0][0] >= runs[-1][1]:
            raise ValueError("empty insert")
        lo = self._first_overlap_idx(runs[0][0], runs[-1][1])
        hi = bisect.bisect_left(self._starts, runs[-1][1], lo)
        out: List[Interval] = []
        k = lo

        def next_existing() -> Optional[Interval]:
            nonlocal k
            if k < hi:
                iv = self._ivals[k]
                k += 1
                return iv
            return None

        cur = next_existing()
        for start, end in runs:
            if end <= start:
                raise ValueError("empty insert")
            # Existing intervals wholly before this piece survive.
            while cur is not None and cur.end <= start:
                out.append(cur)
                cur = next_existing()
            # Overlapped: keep the uncovered flanks (split semantics).
            while cur is not None and cur.start < end:
                if cur.start < start:
                    out.append(Interval(cur.start, start, cur.value))
                if cur.end > end:
                    # The right flank may still overlap LATER pieces:
                    # keep sweeping it as the current interval.
                    cur = Interval(
                        end, cur.end,
                        self._shift_value(cur.value, end - cur.start),
                    )
                else:
                    cur = next_existing()
            out.append(Interval(start, end, value))
        while cur is not None:
            out.append(cur)
            cur = next_existing()
        self._ivals[lo:hi] = out
        self._starts[lo:hi] = [iv.start for iv in out]
        self._ends[lo:hi] = [iv.end for iv in out]
        if self._merge:
            self._merge_around(lo, lo + len(out))

    def remove(self, start: int, end: int) -> List[Interval]:
        """Remove coverage of [start, end); returns the removed (clipped) parts."""
        if end <= start:
            return []
        removed = self.query(start, end)
        if not removed:
            return []
        i = self._first_overlap_idx(start, end)
        new_pieces: List[Interval] = []
        j = i
        while j < len(self._ivals) and self._ivals[j].start < end:
            iv = self._ivals[j]
            if iv.overlaps(start, end):
                if iv.start < start:
                    new_pieces.append(Interval(iv.start, start, iv.value))
                if iv.end > end:
                    new_pieces.append(
                        Interval(
                            end, iv.end,
                            self._shift_value(iv.value, end - iv.start),
                        )
                    )
            else:
                new_pieces.append(iv)
            j += 1
        self._ivals[i:j] = new_pieces
        self._starts[i:j] = [iv.start for iv in new_pieces]
        self._ends[i:j] = [iv.end for iv in new_pieces]
        return removed

    def _merge_around(self, lo: int, hi: int) -> None:
        """Merge contiguous equal-valued intervals in a window around [lo, hi)."""
        lo = max(lo - 1, 0)
        hi = min(hi + 1, len(self._ivals))
        k = lo
        while k < min(hi, len(self._ivals)) - 1:
            a, b = self._ivals[k], self._ivals[k + 1]
            if a.end == b.start and a.value == b.value:
                self._ivals[k] = Interval(a.start, b.end, a.value)
                self._ends[k] = b.end
                del self._ivals[k + 1]
                del self._starts[k + 1]
                del self._ends[k + 1]
                hi -= 1
            else:
                k += 1

    # ------------------------------------------------------------ invariants
    def check_invariants(self) -> None:
        """Disjoint, sorted, starts-index consistent (used by property tests)."""
        assert self._starts == [iv.start for iv in self._ivals]
        assert self._ends == [iv.end for iv in self._ivals]
        for a, b in zip(self._ivals, self._ivals[1:]):
            assert a.end <= b.start, f"overlap: {a} vs {b}"
            if self._merge:
                assert not (a.end == b.start and a.value == b.value), (
                    f"unmerged neighbours: {a} vs {b}"
                )

    @property
    def max_end(self) -> int:
        # Sorted endpoints: the last interval necessarily ends furthest.
        return self._ends[-1] if self._ends else 0


class OwnerIntervalMap(IntervalMap):
    """Global (server-side) tree: range -> owner client id (paper §5.1.2)."""

    def attach(self, start: int, end: int, owner: int) -> None:
        self.insert(start, end, owner)

    def attach_many(self, runs: List[Tuple[int, int]], owner: int) -> None:
        """Attach several ascending disjoint runs in one windowed splice
        (the hot path of a sharded server's multi-range attach RPC)."""
        self.insert_run(runs, owner)

    def detach(self, start: int, end: int, owner: int) -> bool:
        """Detach only the sub-ranges still owned by ``owner``.

        Per the paper: if another client has overwritten (re-attached) the
        range, the detach of the stale parts is a no-op.  Returns True if
        anything was removed.
        """
        stale = [iv for iv in self.query(start, end) if iv.value == owner]
        for iv in stale:
            self.remove(iv.start, iv.end)
        return bool(stale)

    def owners(self, start: int, end: int) -> List[Interval]:
        return self.query(start, end)


@dataclass(frozen=True)
class BufferSlot:
    """Payload of the local tree: where a file range lives in the burst buffer."""

    buf_start: int
    attached: bool

    def shifted(self, delta: int) -> "BufferSlot":
        return BufferSlot(self.buf_start + delta, self.attached)


class BufferIntervalMap(IntervalMap):
    """Local (client-side) tree: file range -> burst-buffer position.

    Each interval value is a :class:`BufferSlot`.  Values are *not* merged by
    equality (buffer offsets differ per write); instead we merge only when the
    buffer ranges are also contiguous, mirroring the paper's local tree.
    """

    def __init__(self) -> None:
        super().__init__(merge_values=False)

    def _shift_value(self, value: "BufferSlot", delta: int) -> "BufferSlot":
        return value.shifted(delta)

    def record_write(self, start: int, end: int, buf_start: int) -> None:
        self.insert(start, end, BufferSlot(buf_start, attached=False))
        self._merge_window(start, end)

    def _merge_window(self, start: int, end: int) -> None:
        """Merge only around the just-touched file range (O(log n + k))."""
        lo = max(self._first_overlap_idx(start, end) - 1, 0)
        hi = bisect.bisect_left(self._starts, end) + 1
        self._merge_contiguous(lo, hi)

    def _merge_contiguous(self, lo: int = 0, hi: Optional[int] = None) -> None:
        if hi is None:
            hi = len(self._ivals)
        k = max(lo, 0)
        while k < min(hi, len(self._ivals)) - 1:
            a, b = self._ivals[k], self._ivals[k + 1]
            va, vb = a.value, b.value
            if (
                a.end == b.start
                and va.attached == vb.attached
                and va.buf_start + a.length == vb.buf_start
            ):
                self._ivals[k] = Interval(a.start, b.end, va)
                self._ends[k] = b.end
                del self._ivals[k + 1]
                del self._starts[k + 1]
                del self._ends[k + 1]
                hi -= 1
            else:
                k += 1

    def mark_attached(self, start: int, end: int) -> None:
        """Flip ``attached`` on every written sub-range of [start, end)."""
        i = bisect.bisect_right(self._starts, start) - 1
        if 0 <= i < len(self._ivals):
            iv = self._ivals[i]
            if iv.start == start and iv.end == end:
                # Exact-cover fast path: a bulk commit tail attaches
                # precisely the interval the write recorded, so the
                # run snapshot and re-insert splice reduce to flipping
                # the one slot in place.
                self._ivals[i] = Interval(
                    start, end, BufferSlot(iv.value.buf_start, True))
                self._merge_window(start, end)
                return
        runs = self.buffer_runs(start, end)  # snapshot before mutating
        for fs, fe, bs in runs:
            self.insert(fs, fe, BufferSlot(bs, True))
        self._merge_window(start, end)

    def lookup_interval(self, pos: int) -> Interval:
        i = bisect.bisect_right(self._starts, pos) - 1
        if i >= 0 and self._ivals[i].start <= pos < self._ivals[i].end:
            return self._ivals[i]
        raise KeyError(pos)

    def written(self, start: int, end: int) -> bool:
        return self.covers(start, end)

    def sole_run(self, start: int, end: int) -> Optional[int]:
        """Buffer offset of [start, end) when ONE stored interval covers
        it entirely, else None (fall back to ``covers``/``buffer_runs``).

        Equivalent to the single tuple ``buffer_runs`` would return in
        that case — one bisect instead of a query plus a per-run
        ``lookup_interval``; the bulk read kernel's owner-read fast
        path.
        """
        iv = self.sole_cover(start, end)
        if iv is None:
            return None
        return iv.value.buf_start + (start - iv.start)

    def buffer_runs(
        self, start: int, end: int, attached: Optional[bool] = None
    ) -> List[Tuple[int, int, int]]:
        """(file_start, file_end, buf_start) runs covering written parts.

        ``attached`` filters to runs with that attach status when not None.
        """
        out = []
        for iv in self.query(start, end):
            base = self.lookup_interval(iv.start)
            slot: BufferSlot = base.value
            if attached is not None and slot.attached != attached:
                continue
            out.append(
                (iv.start, iv.end, slot.buf_start + (iv.start - base.start))
            )
        return out

    def unattached_runs(self) -> List[Tuple[int, int, int]]:
        return [
            (iv.start, iv.end, iv.value.buf_start)
            for iv in self._ivals
            if not iv.value.attached
        ]

    def attached_runs(self) -> List[Tuple[int, int, int]]:
        return [
            (iv.start, iv.end, iv.value.buf_start)
            for iv in self._ivals
            if iv.value.attached
        ]

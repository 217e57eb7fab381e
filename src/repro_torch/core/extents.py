"""Zero-copy data plane for BaseFS: lazy byte payloads ("extents").

The consistency machinery (owner interval trees, the event ledger, the
DES replay) never needed the *bytes* a workload moves — only their
placement and sizes.  This module provides the payload representation
that lets BaseFS stop moving real bytes on the benchmark path:

* :class:`Payload` — an abstract lazy byte string with a length, cheap
  slicing, streaming materialization (:meth:`Payload.chunks`), and
  content equality that short-circuits **symbolically** whenever both
  sides carry identical extent descriptors (the common benchmark path:
  a read of a pattern-written block compares two descriptors in O(1),
  with zero byte materialization);
* :class:`ByteSlab` — real bytes (legacy callers, checkpoint state);
* :class:`PatternExtent` — ``generator(offset, size)[skip:skip+length]``
  without calling the generator; slicing just narrows the window;
* :class:`ZeroExtent` — the PFS zero-fill;
* :class:`Chain` — concatenation (multi-owner reads, stripe splits),
  built through :func:`concat`, which re-coalesces adjacent slices of
  the same underlying extent so a block split and reassembled by the
  read path compares symbolically again;
* :class:`ExtentLog` — the append-only burst-buffer "file" of a
  :class:`~repro_torch.core.basefs.BFSClient`: payload extents addressed by
  byte offset;
* :class:`ExtentFile` — an :class:`~repro_torch.core.intervals.IntervalMap`
  of payloads standing in for one flat file of the underlying PFS.

Everything observable by the cost model (event kinds, byte counts, RPC
placement) is unchanged: ``len(payload)`` is the ledger's ``nbytes``.
``BaseFS(materialize=True)`` retains the byte-moving fallback by
converting every written payload to a :class:`ByteSlab` eagerly — the
ledger and DES output are identical in both modes by construction.
"""

from __future__ import annotations

import bisect
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.intervals import IntervalMap

#: Chunk size for streaming materialization / content comparison.
CHUNK = 1 << 20


class Payload:
    """A lazy byte string; subclasses define ``nbytes`` and the content."""

    __slots__ = ()

    nbytes: int

    # ---- size / materialization ---------------------------------------
    def __len__(self) -> int:
        return self.nbytes

    def chunks(self) -> Iterator[Any]:
        """Yield the content as a stream of bytes-like chunks."""
        raise NotImplementedError

    def to_bytes(self) -> bytes:
        return b"".join(bytes(c) for c in self.chunks())

    def __bytes__(self) -> bytes:
        return self.to_bytes()

    def materialized(self) -> "ByteSlab":
        """Eager byte-mode conversion (``BaseFS(materialize=True)``)."""
        return ByteSlab(self.to_bytes())

    # ---- slicing ------------------------------------------------------
    def slice(self, start: int, length: int) -> "Payload":
        """The sub-payload covering ``[start, start + length)``."""
        raise NotImplementedError

    def _check_window(self, start: int, length: int) -> None:
        if not (0 <= start and 0 <= length and start + length <= self.nbytes):
            raise ValueError(f"slice [{start}, {start + length}) outside {self.nbytes}B payload")

    def __getitem__(self, key):
        """Indexing materializes (diagnostics only — reprs, oracles)."""
        if isinstance(key, slice):
            start, stop, step = key.indices(self.nbytes)
            if step != 1:
                return self.to_bytes()[key]
            return self.slice(start, max(0, stop - start)).to_bytes()
        if key < 0:
            key += self.nbytes
        return self.slice(key, 1).to_bytes()[0]

    # ---- equality -----------------------------------------------------
    def atoms(self) -> Iterator["Payload"]:
        """The flat sequence of non-chain extents composing this payload."""
        yield self

    def key(self) -> Optional[Tuple]:
        """Symbolic descriptor: equal keys imply equal content.

        ``None`` means "no symbolic identity" — equality falls back to a
        streaming content comparison.
        """
        return None

    def __eq__(self, other: object) -> bool:
        if self is other:
            return True
        if isinstance(other, (bytes, bytearray, memoryview)):
            other = ByteSlab(bytes(other))
        if not isinstance(other, Payload):
            return NotImplemented
        if self.nbytes != other.nbytes:
            return False
        # Atom-to-atom symbolic hit (the benchmark verify path: two
        # pattern extents with one descriptor each) — skip building the
        # atom lists entirely.
        k = self.key()
        if k is not None and k == other.key():
            return True
        mine = [a.key() for a in self.atoms()]
        theirs = [b.key() for b in other.atoms()]
        if None not in mine and mine == theirs:
            return True
        return _content_eq(self, other)

    __hash__ = None  # content equality; payloads are not dict keys

    def __repr__(self) -> str:
        # Diagnostics only: small payloads show their content (litmus
        # examples print reads), large ones just their size.
        if self.nbytes <= 64:
            return f"<{type(self).__name__} {self.to_bytes()!r}>"
        return f"<{type(self).__name__} {self.nbytes}B>"


def _content_eq(a: Payload, b: Payload) -> bool:
    """Streaming chunk-aligned content comparison (the honest fallback)."""
    ia, ib = a.chunks(), b.chunks()
    ca = cb = b""
    while True:
        if len(ca) == 0:
            ca = next(ia, None)
        if len(cb) == 0:
            cb = next(ib, None)
        if ca is None or cb is None:
            return ca is None and cb is None
        n = min(len(ca), len(cb))
        if bytes(ca[:n]) != bytes(cb[:n]):
            return False
        ca, cb = ca[n:], cb[n:]


class ByteSlab(Payload):
    """Real bytes (a window into an immutable buffer; slices are views)."""

    __slots__ = ("data", "off", "nbytes")

    def __init__(self, data: bytes, off: int = 0, nbytes: Optional[int] = None):
        self.data = data
        self.off = off
        self.nbytes = len(data) - off if nbytes is None else nbytes

    def chunks(self) -> Iterator[memoryview]:
        yield memoryview(self.data)[self.off : self.off + self.nbytes]

    def to_bytes(self) -> bytes:
        if self.off == 0 and self.nbytes == len(self.data):
            return self.data
        return self.data[self.off : self.off + self.nbytes]

    def materialized(self) -> "ByteSlab":
        return self

    def slice(self, start: int, length: int) -> "ByteSlab":
        self._check_window(start, length)
        return ByteSlab(self.data, self.off + start, length)

    def key(self) -> Tuple:
        return ("b", id(self.data), self.off, self.nbytes)


class ZeroExtent(Payload):
    """``nbytes`` zero bytes (PFS zero-fill; reads past EOF)."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int):
        self.nbytes = nbytes

    def chunks(self) -> Iterator[bytes]:
        left = self.nbytes
        while left > 0:
            n = min(left, CHUNK)
            yield b"\0" * n
            left -= n

    def slice(self, start: int, length: int) -> "ZeroExtent":
        self._check_window(start, length)
        return ZeroExtent(length)

    def key(self) -> Tuple:
        return ("z", self.nbytes)


class PatternExtent(Payload):
    """``gen(offset, size)[skip : skip + nbytes]`` — held symbolically.

    ``gen`` must be deterministic; symbolic identity is the callable's
    object identity plus the window, so two extents with equal
    descriptors are equal with no generator call at all.  The generator
    output is NOT assumed shift-invariant: slicing narrows the
    ``(skip, nbytes)`` window over the SAME ``gen(offset, size)`` call,
    never re-addresses it.
    """

    __slots__ = ("gen", "offset", "size", "skip", "nbytes")

    def __init__(self, gen, offset: int, size: int, skip: int = 0, nbytes: Optional[int] = None):
        self.gen = gen
        self.offset = offset
        self.size = size
        self.skip = skip
        self.nbytes = size - skip if nbytes is None else nbytes
        if not (0 <= self.skip and self.skip + self.nbytes <= size):
            raise ValueError(f"pattern window outside the generated {size} bytes")

    def chunks(self) -> Iterator[bytes]:
        yield self.gen(self.offset, self.size)[self.skip : self.skip + self.nbytes]

    def slice(self, start: int, length: int) -> "PatternExtent":
        self._check_window(start, length)
        return PatternExtent(self.gen, self.offset, self.size, self.skip + start, length)

    def key(self) -> Tuple:
        return ("p", id(self.gen), self.offset, self.size, self.skip, self.nbytes)


class Chain(Payload):
    """Concatenation of payloads; build through :func:`concat`."""

    __slots__ = ("parts", "nbytes")

    def __init__(self, parts: Sequence[Payload]):
        self.parts = tuple(parts)
        self.nbytes = sum(p.nbytes for p in self.parts)

    def chunks(self) -> Iterator[Any]:
        for p in self.parts:
            yield from p.chunks()

    def atoms(self) -> Iterator[Payload]:
        for p in self.parts:
            yield from p.atoms()

    def slice(self, start: int, length: int) -> Payload:
        self._check_window(start, length)
        out: List[Payload] = []
        pos = start
        end = start + length
        base = 0
        for p in self.parts:
            if base >= end:
                break
            if base + p.nbytes > pos:
                s = pos - base
                n = min(end, base + p.nbytes) - pos
                out.append(p.slice(s, n))
                pos += n
            base += p.nbytes
        return concat(out)


def _coalesce_pair(a: Payload, b: Payload) -> Optional[Payload]:
    """Merge two adjacent atoms when their union has a symbolic identity."""
    if isinstance(a, ZeroExtent) and isinstance(b, ZeroExtent):
        return ZeroExtent(a.nbytes + b.nbytes)
    if (
        isinstance(a, PatternExtent)
        and isinstance(b, PatternExtent)
        and a.gen is b.gen
        and a.offset == b.offset
        and a.size == b.size
        and a.skip + a.nbytes == b.skip
    ):
        return PatternExtent(a.gen, a.offset, a.size, a.skip, a.nbytes + b.nbytes)
    if (
        isinstance(a, ByteSlab)
        and isinstance(b, ByteSlab)
        and a.data is b.data
        and a.off + a.nbytes == b.off
    ):
        return ByteSlab(a.data, a.off, a.nbytes + b.nbytes)
    return None


def concat(parts: Iterable[Payload]) -> Payload:
    """Concatenate payloads, re-coalescing reassembled extents.

    A block written as ONE extent, split by stripe/owner boundaries and
    read back piecewise, coalesces back to the single extent — so the
    symbolic equality of the verification path survives the split.
    """
    out: List[Payload] = []
    for part in parts:
        for atom in part.atoms():
            if atom.nbytes == 0:
                continue
            if out:
                merged = _coalesce_pair(out[-1], atom)
                if merged is not None:
                    out[-1] = merged
                    continue
            out.append(atom)
    if not out:
        return ZeroExtent(0)
    if len(out) == 1:
        return out[0]
    return Chain(out)


def as_payload(data: Any) -> Payload:
    """Adopt caller data: payloads pass through, bytes-likes are wrapped."""
    if isinstance(data, Payload):
        return data
    if isinstance(data, bytes):
        return ByteSlab(data)
    if isinstance(data, (bytearray, memoryview)):
        return ByteSlab(bytes(data))
    raise TypeError(f"cannot adopt {type(data).__name__} as a payload")


# --------------------------------------------------------------------------
# Storage containers built on payloads.
# --------------------------------------------------------------------------
class ExtentLog:
    """Append-only extent store addressed by byte offset.

    The node-local burst-buffer "file" of one client: writes append a
    payload and get back its buffer offset; reads return (possibly
    re-coalesced) slices.  No byte is ever copied in.
    """

    __slots__ = ("_offs", "_parts", "nbytes")

    def __init__(self) -> None:
        self._offs: List[int] = []
        self._parts: List[Payload] = []
        self.nbytes = 0

    def __len__(self) -> int:
        return self.nbytes

    def append(self, payload: Payload) -> int:
        off = self.nbytes
        self._offs.append(off)
        self._parts.append(payload)
        self.nbytes += payload.nbytes
        return off

    def read(self, start: int, size: int) -> Payload:
        if size < 0 or start < 0 or start + size > self.nbytes:
            raise ValueError(f"read [{start}, {start + size}) outside the extent log")
        if size == 0:
            return ZeroExtent(0)
        i = bisect.bisect_right(self._offs, start) - 1
        base, p = self._offs[i], self._parts[i]
        s = start - base
        if s + size <= p.nbytes:
            # Whole read inside one appended extent (block-aligned
            # reads of block-aligned writes — the benchmark hot path):
            # no chain, no re-coalescing; the stored payload (or a
            # window of it) IS the result.  Payloads are immutable, so
            # handing the stored object back is safe.
            return p if s == 0 and size == p.nbytes else p.slice(s, size)
        parts: List[Payload] = []
        pos, end = start, start + size
        while pos < end:
            base, p = self._offs[i], self._parts[i]
            s = pos - base
            n = min(end - pos, p.nbytes - s)
            parts.append(p.slice(s, n))
            pos += n
            i += 1
        return concat(parts)


class _PayloadIntervalMap(IntervalMap):
    """Disjoint file ranges -> payloads, with split-aware payload windows."""

    def __init__(self) -> None:
        super().__init__(merge_values=False)

    def _shift_value(self, value: Payload, delta: int) -> Payload:
        return value.slice(delta, value.nbytes - delta)

    def payload_runs(self, start: int, end: int) -> List[Tuple[int, int, Payload]]:
        """(start, end, payload) pieces covering the stored parts of the range."""
        out: List[Tuple[int, int, Payload]] = []
        i = self._first_overlap_idx(start, end)
        while i < len(self._ivals) and self._ivals[i].start < end:
            iv = self._ivals[i]
            if iv.overlaps(start, end):
                s, e = max(iv.start, start), min(iv.end, end)
                out.append((s, e, iv.value.slice(s - iv.start, e - s)))
            i += 1
        return out


class ExtentFile:
    """One flat file of the underlying PFS as an interval map of payloads.

    Overlapping writes overwrite (the interval map splits the losers and
    narrows their payload windows); reads zero-fill unwritten gaps and
    anything past EOF, matching the byte-mode semantics exactly.
    """

    __slots__ = ("_map", "size")

    def __init__(self) -> None:
        self._map = _PayloadIntervalMap()
        self.size = 0

    def write(self, offset: int, payload: Payload) -> None:
        if payload.nbytes == 0:
            return
        self._map.insert(offset, offset + payload.nbytes, payload)
        self.size = max(self.size, offset + payload.nbytes)

    def read(self, offset: int, size: int) -> Payload:
        if size <= 0:
            return ZeroExtent(0)
        parts: List[Payload] = []
        pos = offset
        end = offset + size
        for s, e, payload in self._map.payload_runs(offset, end):
            if s > pos:
                parts.append(ZeroExtent(s - pos))
            parts.append(payload)
            pos = e
        if pos < end:
            parts.append(ZeroExtent(end - pos))
        return concat(parts)

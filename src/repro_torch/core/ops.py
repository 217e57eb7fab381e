"""Struct-of-arrays op programs — the bulk submission format.

A compiled *op program* is the columnar form of a workload's inner
loop: parallel ``op`` / ``client`` / ``file`` / ``offset`` / ``size``
columns, one entry per logical layer operation, in exactly the order
the scalar loop would have issued them.  Workloads compile their
round-robin write/read loops (and dlio epochs) into programs once and
hand them to the consistency layer's :meth:`run_ops`
(:mod:`repro_torch.core.consistency`) — the ONLY legal entry into the bulk
execution kernels (lint rule ANA005), which is what keeps every sync
point, fence, and ``sync_op_kinds`` hook at its recorded position.

Programs are pure data: building or slicing one performs no I/O.  The
slicing invariant is load-bearing — executing ``prog`` in one call and
executing ``prog.slice(0, k)`` then ``prog.slice(k, len(prog))`` (any
chunking) produce bitwise-identical ledgers, which is the
hypothesis-tested contract that makes chunked/streamed submission safe.

Opcodes
-------
``OP_WRITE``/``OP_READ`` carry ``offset``/``size`` and imply the
``seek(offset)`` the scalar loop issues before each access (seeks move
client-local state only; no event is recorded).  The control opcodes
(``OP_COMMIT``, ``OP_SESSION_OPEN``, ``OP_SESSION_CLOSE``,
``OP_FILE_SYNC``) name the layer's sync methods and always execute
through them, never through a kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Tuple

OP_WRITE = 0
OP_READ = 1
OP_COMMIT = 2
OP_SESSION_OPEN = 3
OP_SESSION_CLOSE = 4
OP_FILE_SYNC = 5

OP_NAMES = {
    OP_WRITE: "write",
    OP_READ: "read",
    OP_COMMIT: "commit",
    OP_SESSION_OPEN: "session_open",
    OP_SESSION_CLOSE: "session_close",
    OP_FILE_SYNC: "file_sync",
}

#: Opcodes that execute through the layer's sync methods (the
#: ``sync_op_kinds`` surface) — never through a bulk kernel.
CONTROL_OPS = frozenset((OP_COMMIT, OP_SESSION_OPEN, OP_SESSION_CLOSE,
                         OP_FILE_SYNC))


@dataclass
class OpProgram:
    """Columnar op stream: parallel lists, one entry per operation.

    ``client`` holds caller-chosen ids (the keys of the handle map
    passed to ``run_ops``); ``file`` indexes :attr:`paths` (kept for
    multi-file programs — the shipped workloads use one shared file).
    """

    op: List[int] = field(default_factory=list)
    client: List[int] = field(default_factory=list)
    file: List[int] = field(default_factory=list)
    offset: List[int] = field(default_factory=list)
    size: List[int] = field(default_factory=list)
    paths: Tuple[str, ...] = ()

    def __len__(self) -> int:
        return len(self.op)

    def add(self, op: int, client: int, file: int = 0, offset: int = 0,
            size: int = 0) -> "OpProgram":
        self.op.append(op)
        self.client.append(client)
        self.file.append(file)
        self.offset.append(offset)
        self.size.append(size)
        return self

    @classmethod
    def from_ops(cls, ops: Iterable[Tuple[int, int, int, int]],
                 paths: Tuple[str, ...] = ()) -> "OpProgram":
        """Build from ``(op, client, offset, size)`` tuples (file = 0)."""
        p = cls(paths=paths)
        for op, client, offset, size in ops:
            p.add(op, client, offset=offset, size=size)
        return p

    def slice(self, i: int, j: int) -> "OpProgram":
        """Sub-program of ops [i, j) — shares the paths table."""
        return OpProgram(self.op[i:j], self.client[i:j], self.file[i:j],
                         self.offset[i:j], self.size[i:j], self.paths)

    def check(self) -> "OpProgram":
        """Validate the column-length invariant and opcode range."""
        n = len(self.op)
        for col in (self.client, self.file, self.offset, self.size):
            if len(col) != n:
                raise ValueError("op program columns have unequal lengths")
        for o in self.op:
            if o not in OP_NAMES:
                raise ValueError(f"unknown opcode {o}")
        return self

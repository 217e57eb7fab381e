"""The paper's file-system stack, copied from ``repro.core``.

These modules are framework-free Python and numpy.  They are copies of the
reference's modules of the same name; only their imports differ, so the
port imports nothing of ``repro``.  They carry the checkpoint path
(:mod:`repro_torch.checkpoint`).

* :mod:`repro_torch.core.routing`     — metadata-shard routing
* :mod:`repro_torch.core.intervals`   — interval maps (paper §5.1.2 trees)
* :mod:`repro_torch.core.extents`     — zero-copy data plane (lazy payload extents)
* :mod:`repro_torch.core.ops`         — compiled op programs
* :mod:`repro_torch.core.basefs`      — BaseFS primitives (Table 5) + event ledger
* :mod:`repro_torch.core.consistency` — PosixFS / CommitFS / SessionFS / MPIIOFS (Table 6)
* :mod:`repro_torch.core.costmodel`   — discrete-event replay on Catalyst constants (§6)
* :mod:`repro_torch.core.vecreplay`   — the replay's struct-of-arrays engine

``repro.core.model`` (the formal SCNF framework), ``checker`` and
``faults`` are not yet copied (ROADMAP.md queue 1 item 4), so their names
are not exported here.
"""

from repro_torch.core.basefs import BaseFS, EventKind, EventLedger
from repro_torch.core.extents import (
    ByteSlab,
    Chain,
    ExtentFile,
    ExtentLog,
    PatternExtent,
    Payload,
    ZeroExtent,
    as_payload,
    concat,
)
from repro_torch.core.consistency import (
    CommitFS,
    MPIIOFS,
    PosixFS,
    SessionFS,
    make_fs,
)
from repro_torch.core.costmodel import CostModel, HardwareConstants

__all__ = [
    "BaseFS",
    "EventKind",
    "EventLedger",
    "Payload",
    "ByteSlab",
    "PatternExtent",
    "ZeroExtent",
    "Chain",
    "ExtentLog",
    "ExtentFile",
    "as_payload",
    "concat",
    "CommitFS",
    "MPIIOFS",
    "PosixFS",
    "SessionFS",
    "make_fs",
    "CostModel",
    "HardwareConstants",
]

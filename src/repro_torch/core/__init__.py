"""The paper's file-system stack, copied from ``repro.core``.

These modules are framework-free Python and numpy.  They are copies of the
reference's modules of the same name; only their imports differ, so the
port imports nothing of ``repro``.  They carry the checkpoint path
(:mod:`repro_torch.checkpoint`), data ingest (:mod:`repro_torch.data`), the
paper's workloads (:mod:`repro_torch.io`) and the analysis plane
(:mod:`repro_torch.analysis`).

* :mod:`repro_torch.core.routing`     — metadata-shard routing
* :mod:`repro_torch.core.intervals`   — interval maps (paper §5.1.2 trees)
* :mod:`repro_torch.core.extents`     — zero-copy data plane (lazy payload extents)
* :mod:`repro_torch.core.ops`         — compiled op programs
* :mod:`repro_torch.core.basefs`      — BaseFS primitives (Table 5) + event ledger
* :mod:`repro_torch.core.consistency` — PosixFS / CommitFS / SessionFS / MPIIOFS (Table 6)
* :mod:`repro_torch.core.costmodel`   — discrete-event replay on Catalyst constants (§6)
* :mod:`repro_torch.core.vecreplay`   — the replay's struct-of-arrays engine
* :mod:`repro_torch.core.faults`      — seeded fault injection (FaultSchedule)
* :mod:`repro_torch.core.model`       — formal SCNF framework (§4, Table 4)
* :mod:`repro_torch.core.checker`     — storage-race detection + SC oracle on real runs
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
from repro_torch.core.model import (
    COMMIT_MODEL,
    COMMIT_RELAXED_MODEL,
    Execution,
    MODELS,
    MPIIO_MODEL,
    POSIX_MODEL,
    SESSION_MODEL,
)

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
    "Execution",
    "MODELS",
    "POSIX_MODEL",
    "COMMIT_MODEL",
    "COMMIT_RELAXED_MODEL",
    "SESSION_MODEL",
    "MPIIO_MODEL",
]

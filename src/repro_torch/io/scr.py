"""SCR checkpoint/restart case study (paper §6.2) — HACC-IO via an emulator.

Emulates the paper's exact scenario:

* SCR "Partner" redundancy, node-local storage only.  Each rank buffers its
  checkpoint in node memory, flushes to the node-local SSD, and a copy goes
  to the memory + SSD of a partner rank on another node (failure group).
* Client: HACC-IO.  Each checkpoint step writes 9 arrays (xx,yy,zz,vx,vy,
  vz,phi: float32; pid: int64; mask: uint16 -> 38 B/particle), one array at
  a time, file-per-process.  Total size set by the particle count (paper:
  10 million).
* Restart after a single-node failure with one spare node: surviving ranks
  read their 9 arrays straight from the memory buffer; the spare node
  receives the failed node's checkpoint from the partner via MPI — that
  transfer is EXCLUDED from the read bandwidth, as in the paper (Fig 5).

The consistency layer (CommitFS or SessionFS) carries every file
operation, so the RPC placement difference — commit: one query per read;
session: one query per session — is measured, not assumed.  That is what
produces the paper's restart-scalability gap.

Bandwidth accounting: checkpoint bandwidth counts bytes physically written
to SSDs (local + partner copies) over the phase makespan — this is the
device-level figure the paper reports as "peak"; restart bandwidth counts
application bytes read.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.core.basefs import TOPOLOGY, BaseFS, EventKind
from repro_torch.core.consistency import FileHandle, make_fs
from repro_torch.core.costmodel import CostModel, HardwareConstants, PhaseResult
from repro_torch.core.faults import FaultSchedule
from repro_torch.io.workloads import pattern_extent

#: HACC particle record: 7 float32 + 1 int64 + 1 uint16 (38 bytes).
HACC_ARRAYS: Tuple[Tuple[str, int], ...] = (
    ("xx", 4), ("yy", 4), ("zz", 4),
    ("vx", 4), ("vy", 4), ("vz", 4),
    ("phi", 4), ("pid", 8), ("mask", 2),
)
BYTES_PER_PARTICLE = sum(sz for _, sz in HACC_ARRAYS)  # 38


@dataclass(frozen=True)
class SCRConfig:
    n: int                       # total nodes INCLUDING one spare
    model: str                   # "commit" | "session"
    p: int = 12                  # processes per node
    particles: int = 10_000_000  # paper: 10M total
    failed_node: int = 0         # node that dies before restart

    def __post_init__(self) -> None:
        if self.n < 2:
            raise ValueError(
                f"SCR needs at least one write node plus the spare "
                f"(n={self.n})")
        if not 0 <= self.failed_node < self.write_nodes:
            raise ValueError(
                f"failed_node={self.failed_node} is not a write node "
                f"(valid: 0..{self.write_nodes - 1}; node "
                f"{self.write_nodes} is the spare)")

    @property
    def write_nodes(self) -> int:
        return self.n - 1        # one spare (paper: "one spare node")

    @property
    def ranks(self) -> int:
        return self.write_nodes * self.p

    @property
    def particles_per_rank(self) -> int:
        return self.particles // self.ranks

    @property
    def bytes_per_rank(self) -> int:
        return self.particles_per_rank * BYTES_PER_PARTICLE


@dataclass
class SCRResult:
    config: SCRConfig
    phases: List[PhaseResult]
    checkpoint_bytes: int
    restart_bytes: int
    rpc_counts: Dict[str, int] = field(default_factory=dict)
    verified_reads: int = 0

    def phase(self, name: str) -> PhaseResult:
        for ph in self.phases:
            if ph.name == name:
                return ph
        raise KeyError(name)

    @property
    def checkpoint_bandwidth(self) -> float:
        ph = self.phase("checkpoint")
        return self.checkpoint_bandwidth_of(ph)

    def checkpoint_bandwidth_of(self, ph: PhaseResult) -> float:
        ssd = ph.bytes_by_kind.get(EventKind.SSD_WRITE, 0)
        return ssd / ph.duration if ph.duration else 0.0

    @property
    def restart_bandwidth(self) -> float:
        ph = self.phase("restart")
        nbytes = (ph.bytes_by_kind.get(EventKind.MEM_READ, 0)
                  + ph.bytes_by_kind.get(EventKind.NET_TRANSFER, 0))
        return nbytes / ph.duration if ph.duration else 0.0


def _ckpt_path(rank: int) -> str:
    return f"/scr/ckpt.0/rank_{rank}.scr"


def run_scr(cfg: SCRConfig, hw: Optional[HardwareConstants] = None,
            verify: bool = True,
            timings: Optional[Dict[str, float]] = None,
            tracer=None,
            faults: Optional[FaultSchedule] = None) -> SCRResult:
    t0 = _time.perf_counter()
    # The node failure is an *injected fault*, not a hardcoded branch: the
    # default schedule loses exactly cfg.failed_node, and a caller-supplied
    # schedule replaces it wholesale (lost_nodes drives which ranks restart
    # from the spare; buffer_loss_nodes makes survivors whose memory buffer
    # was dropped fall back to the partner copy; drop/crash/slow fields are
    # injected into the RPC plane like any other run).  A process-wide
    # schedule (``set_topology(faults=...)``, e.g. ``benchmarks.run
    # --faults``) is honored, gaining the fig-5 node loss if it names none.
    if faults is None:
        faults = TOPOLOGY.get("faults")
    if faults is None:
        faults = FaultSchedule(lost_nodes=(cfg.failed_node,))
    elif not faults.lost_nodes:
        faults = replace(faults, lost_nodes=(cfg.failed_node,))
    lost_nodes = set(faults.lost_nodes)
    buffer_loss = set(faults.buffer_loss_nodes) - lost_nodes
    for v in sorted(lost_nodes | buffer_loss):
        if not 0 <= v < cfg.write_nodes:
            raise ValueError(
                f"fault schedule names node {v}, which is not a write "
                f"node (valid: 0..{cfg.write_nodes - 1})")
    fs = BaseFS(faults=faults)
    layer = make_fs(cfg.model, fs)
    if tracer is not None:
        # Lift the run into the formal execution (repro_torch.analysis.trace);
        # the proxy delegates every call, the run is unchanged.
        layer = tracer.attach(layer)
    ledger = fs.ledger
    ranks = cfg.ranks
    p = cfg.p

    def node_of(rank: int) -> int:
        return rank // p

    def partner_node(v: int) -> int:
        # Partner scheme: next node in the failure ring (paper §6.2).
        return (v + 1) % cfg.write_nodes

    # Memory-tier clients: SCR buffers checkpoints in node memory first.
    for rank in range(ranks):
        fs.client(rank, node=node_of(rank), tier="mem")
    # Auxiliary clients that model the partner-side copy engine per rank.
    AUX = 1_000_000
    for rank in range(ranks):
        fs.client(AUX + rank, node=partner_node(node_of(rank)), tier="mem")

    # ==== checkpoint phase ==================================================
    ledger.mark_phase("checkpoint")
    handles: Dict[int, FileHandle] = {}
    for rank in range(ranks):
        fh = layer.open(rank, _ckpt_path(rank), node=node_of(rank))
        handles[rank] = fh
        if cfg.model == "session":
            layer.session_open(fh)
    nper = cfg.particles_per_rank
    for rank in range(ranks):
        fh = handles[rank]
        off = 0
        for _name, esz in HACC_ARRAYS:
            nbytes = nper * esz
            layer.seek(fh, off)
            layer.write(fh, pattern_extent(off, nbytes))  # -> MEM_WRITE
            off += nbytes
    ckpt_bytes = 0
    for rank in range(ranks):
        fh = handles[rank]
        # Publish (attach) per the consistency model: this is what makes the
        # checkpoint visible for a restart on a *different* set of ranks.
        if cfg.model == "commit":
            layer.commit(fh)
        else:
            layer.session_close(fh)
        # Flush memory buffer -> node-local SSD (local copy) ...
        ledger.record(EventKind.SSD_WRITE, rank, cfg.bytes_per_rank)
        # ... and ship + flush the partner copy (charged to the aux client
        # so the partner node's SSD/NIC contention is modeled, while the
        # sender rank's chain stays its own).
        ledger.record(EventKind.NET_TRANSFER, AUX + rank,
                      cfg.bytes_per_rank, rpc_type="mem", peer=rank)
        ledger.record(EventKind.SSD_WRITE, AUX + rank, cfg.bytes_per_rank)
        ckpt_bytes += 2 * cfg.bytes_per_rank

    # ==== restart phase =====================================================
    # The schedule's lost nodes die.  Their ranks are re-spawned on the spare
    # node (node id = write_nodes): they fetch the partner copy over MPI —
    # that transfer is measured in its own phase ("spare_recover") and
    # EXCLUDED from restart bandwidth, exactly like the paper's Fig 5
    # accounting.  Surviving ranks on a burst-buffer-loss node lost their
    # memory copy but not the node: they restart in place from the partner
    # copy over the network instead of the local buffer.
    ledger.mark_phase("restart")
    restart_bytes = 0
    verified = 0
    for rank in range(ranks):
        if node_of(rank) in lost_nodes:
            continue
        from_partner = node_of(rank) in buffer_loss
        fh = layer.open(rank, _ckpt_path(rank), node=node_of(rank))
        if cfg.model == "session":
            layer.session_open(fh)
        off = 0
        for _name, esz in HACC_ARRAYS:
            nbytes = nper * esz
            layer.seek(fh, off)
            if from_partner:
                # Partner copy pulled memory-to-memory (same hand-modeled
                # idiom as the checkpoint-side partner ship); counted in
                # restart bandwidth via NET_TRANSFER.
                ledger.record(EventKind.NET_TRANSFER, rank, nbytes,
                              rpc_type="mem", peer=AUX + rank)
            else:
                data = layer.read(fh, nbytes)  # MEM_READ from own buffer
                if verify:
                    # Symbolic descriptor compare on the extent plane.
                    assert data == pattern_extent(off, nbytes), (
                        f"restart mismatch rank={rank} array={_name}"
                    )
                    verified += 1
            off += nbytes
            restart_bytes += nbytes
        if cfg.model == "session":
            layer.session_close(fh)

    ledger.mark_phase("spare_recover")
    for rank in range(ranks):
        if node_of(rank) not in lost_nodes:
            continue
        # Spare-node rank pulls the partner copy (memory-to-memory over MPI).
        spare_cid = 2_000_000 + rank
        fs.client(spare_cid, node=cfg.write_nodes, tier="mem")
        ledger.record(EventKind.NET_TRANSFER, spare_cid,
                      cfg.bytes_per_rank, rpc_type="mem", peer=AUX + rank)

    fs.drain()  # flush tail send-queue batches so the DES prices them
    t1 = _time.perf_counter()
    phases = CostModel(hw).replay(ledger)
    t2 = _time.perf_counter()
    if timings is not None:
        timings["exec_s"] = t1 - t0
        timings["replay_s"] = t2 - t1
        timings["events"] = ledger.n_events
    rpcs = {
        t: ledger.count(EventKind.RPC, t)
        for t in ("attach", "query", "detach", "stat", "replay")
    }
    return SCRResult(cfg, phases, ckpt_bytes, restart_bytes, rpcs, verified)

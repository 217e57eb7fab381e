"""Synthetic N-to-1 parallel I/O workloads (paper §6.1, Tables 7 & 8).

Every workload writes and/or reads ONE shared file.  The write phase (if
any) completes before the read phase begins (global barrier = ledger phase
marker).  Patterns:

* ``contig``  — rank ``i`` owns the contiguous block ``[i*m*s, (i+1)*m*s)``.
* ``strided`` — access ``j`` of rank ``i`` goes to offset ``(j*R + i) * s``.
* ``random``  — a seeded permutation of all written blocks is dealt to the
  readers (the DL ingestion pattern, §6.3).
* ``hot``     — skewed-offset reads: each access hits a small hot region
  at the head of the file with probability ``hot_frac``, else a uniform
  written block (the metadata-hotspot pattern fig8 uses to exercise the
  adaptive router; seeded, reproducible via ``benchmarks.run --seed``).

Each workload runs on a consistency layer from
:mod:`repro_torch.core.consistency`; per Table 6 the ONLY difference between the
runs is the placement of ``attach``/``query`` primitives.  Reads are
verified against the deterministic write pattern, so every benchmark run
is also an end-to-end correctness check of the consistency layer.  On the
default zero-copy data plane the verification is *symbolic* — the write
path stores :func:`pattern_extent` descriptors and the read path hands
them back re-coalesced, so equality is a descriptor compare and no
payload byte is ever materialized (``--materialize`` restores the
byte-moving plane with byte-for-byte verification).
"""

from __future__ import annotations

import random as _random
import time as _time
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional

# TOPOLOGY/set_topology are re-exported for the benchmark drivers.
from repro_torch.core import ops as opstream
from repro_torch.core.basefs import (BaseFS, EventKind,  # noqa: F401
                               TOPOLOGY, set_topology)
from repro_torch.core.consistency import FileHandle, make_fs
from repro_torch.core.costmodel import CostModel, HardwareConstants, PhaseResult
from repro_torch.core.extents import PatternExtent, Payload

SHARED_FILE = "/shared/workload.dat"

#: Process-wide default DES replay engine (``benchmarks.run --engine``):
#: ``"scalar"`` (the reference per-event loop) or ``"vector"`` (the
#: struct-of-arrays engine, bitwise-identical results).  Replay choice,
#: not deployment topology — hence not part of :data:`TOPOLOGY`.
REPLAY = {"engine": "scalar"}

#: Process-wide default execution mode (``benchmarks.run --exec``):
#: ``"bulk"`` compiles the workload inner loops into op programs
#: (:mod:`repro_torch.core.ops`) and submits them through the layer's
#: ``run_ops`` bulk API; ``"scalar"`` keeps the reference op-by-op
#: loop.  The recorded ledgers are bitwise-identical either way (the
#: golden/hypothesis contract in ``tests/test_bulkexec.py``) — this
#: only selects how fast execution happens, never what it records.
EXEC = {"mode": "bulk"}


def set_replay_engine(engine: str) -> None:
    """Set the process-wide default for ``run_workload(engine=...)``."""
    if engine not in ("scalar", "vector"):
        raise ValueError(f"unknown replay engine {engine!r}")
    REPLAY["engine"] = engine


def set_exec_mode(mode: str) -> None:
    """Set the process-wide default for ``run_workload(bulk=...)``."""
    if mode not in ("bulk", "scalar"):
        raise ValueError(f"unknown exec mode {mode!r}")
    EXEC["mode"] = mode

#: Memoize fully-expanded patterns up to this size (8 KB and the 116 KB
#: DL sample both fit; 8 MB expansions stay uncached to bound the cache
#: at ``256 x 256 KB = 64 MB`` worst-case).
_PATTERN_CACHE_MAX = 256 * 1024


@lru_cache(maxsize=256)
def _pattern_template(head: int, body0: int, size: int) -> bytes:
    """Expand one (head, body-start, size) template."""
    body = bytes((body0 + i) & 0xFF for i in range(min(size, 64)))
    reps = size // len(body) + 1 if body else 0
    return (bytes([head]) + (body * reps))[:size] if size else b""


def pattern_bytes(offset: int, size: int) -> bytes:
    """Deterministic, offset-addressed fill so any read is verifiable.

    The content depends on ``offset`` only through a (head byte,
    body-start byte) template, so expansions are memoized per template —
    read verification in byte mode no longer rebuilds the 64-byte body
    (nor the full block, for cacheable sizes) on every call.
    """
    head = (offset * 2654435761) & 0xFF
    body0 = (offset >> 3) & 0xFF
    if size <= _PATTERN_CACHE_MAX:
        return _pattern_template(head, body0, size)
    return _pattern_template.__wrapped__(head, body0, size)


def pattern_extent(offset: int, size: int) -> PatternExtent:
    """The symbolic form of :func:`pattern_bytes`: a zero-copy extent
    descriptor.  Writing and verifying these is the benchmark fast path —
    a read that round-trips the descriptor compares in O(1) with no byte
    materialization (see :mod:`repro_torch.core.extents`)."""
    return PatternExtent(pattern_bytes, offset, size)


def _pattern_key(offset: int, size: int) -> tuple:
    return ("p", id(pattern_bytes), offset, size, 0, size)


# Symbolic-verification hint for the bulk read kernels: any payload
# whose ``key()`` equals ``key_for(offset, size)`` is equal to
# ``pattern_extent(offset, size)`` without constructing it (see
# ``BaseFS._bulk_read_run_vec``).  Only attach this to PURE expectation
# callbacks — the kernel skips the call entirely on a key hit.
pattern_extent.key_for = _pattern_key


@dataclass(frozen=True)
class WorkloadConfig:
    """Table 7 parameters + Table 8 phase patterns."""

    name: str
    model: str                      # consistency layer: commit|session|posix|mpiio
    write_pattern: Optional[str]    # contig | strided | None
    read_pattern: Optional[str]     # contig | strided | random | None
    n_w: int                        # writing nodes
    n_r: int                        # reading nodes
    p: int = 12                     # processes per node
    m_w: int = 10                   # writes per writing process
    m_r: int = 10                   # reads per reading process
    s: int = 8 * 1024               # access size (8KB small / 8MB large)
    seed: int = 0                   # for random/hot read assignment
    hot_frac: float = 0.0           # "hot" pattern: P(access in hot region)
    hot_blocks: int = 0             # "hot" pattern: hot region, in blocks
    hot_stride: int = 1             # "hot" pattern: blocks between hot blocks
    pfs_drain: bool = False         # flush buffers to the PFS in-phase
    tier: str = "ssd"               # burst-buffer tier: ssd | mem (SCR)

    @property
    def n(self) -> int:
        return self.n_w + self.n_r

    @property
    def writers(self) -> int:
        return self.n_w * self.p

    @property
    def readers(self) -> int:
        return self.n_r * self.p


# ---- Table 8 factories ----------------------------------------------------
def cn_w(n: int, s: int, model: str, p: int = 12, m: int = 10) -> WorkloadConfig:
    return WorkloadConfig(f"CN-W/{model}", model, "contig", None, n, 0, p, m, m, s)


def sn_w(n: int, s: int, model: str, p: int = 12, m: int = 10) -> WorkloadConfig:
    return WorkloadConfig(f"SN-W/{model}", model, "strided", None, n, 0, p, m, m, s)


def cc_r(n: int, s: int, model: str, p: int = 12, m: int = 10) -> WorkloadConfig:
    return WorkloadConfig(
        f"CC-R/{model}", model, "contig", "contig", n // 2, n // 2, p, m, m, s
    )


def cs_r(n: int, s: int, model: str, p: int = 12, m: int = 10) -> WorkloadConfig:
    return WorkloadConfig(
        f"CS-R/{model}", model, "contig", "strided", n // 2, n // 2, p, m, m, s
    )


def rn_r(n: int, s: int, model: str, p: int = 12, m: int = 10,
         seed: int = 0) -> WorkloadConfig:
    """Random read-after-write (the DL-style access pattern within §6.1)."""
    return WorkloadConfig(
        f"RN-R/{model}", model, "contig", "random", n // 2, n // 2, p, m, m,
        s, seed
    )


def rn_r_hot(n: int, s: int, model: str, p: int = 12, m: int = 10,
             seed: int = 0, hot_frac: float = 0.9,
             hot_blocks: int = 16) -> WorkloadConfig:
    """Hot-region read-after-write: ``hot_frac`` of the reads hammer the
    first ``hot_blocks`` written blocks (a skewed-offset metadata hotspot;
    fig8's workload for the adaptive router).  Runs on the memory
    burst-buffer tier (SCR-preloaded, as in fig6) so the metadata path —
    not the hot node's SSD — is the contended resource under study."""
    return WorkloadConfig(
        f"RN-R-hot/{model}", model, "contig", "hot", n // 2, n // 2, p, m,
        m, s, seed, hot_frac=hot_frac, hot_blocks=hot_blocks, tier="mem"
    )


def rn_r_hot_set(n: int, s: int, model: str, p: int = 12, m: int = 10,
                 seed: int = 0, hot_frac: float = 0.9,
                 hot_blocks: int = 16, hot_stride: int = 8) -> WorkloadConfig:
    """Non-contiguous hot SET: the hot blocks sit ``hot_stride`` blocks
    apart instead of forming one head region.  With ``hot_stride`` a
    multiple of the shard count, once the adaptive router shrinks the
    stripe width to the access size every hot stripe index is congruent
    mod ``num_shards`` — the whole hot set collides on ONE shard, and
    only the rebalancer's override/move path can spread it again (the
    fig8 workload that exercises that path; under the static 64 KiB
    stripes the same set is spread round-robin and needs no help)."""
    return WorkloadConfig(
        f"RN-R-hotset/{model}", model, "contig", "hot", n // 2, n // 2, p,
        m, m, s, seed, hot_frac=hot_frac, hot_blocks=hot_blocks,
        hot_stride=hot_stride, tier="mem"
    )


def ckpt_w(n: int, s: int, model: str, p: int = 12,
           m: int = 10) -> WorkloadConfig:
    """Checkpoint writers: contiguous N-1 writes followed by an in-phase
    burst-buffer drain to the underlying PFS (fig7's overlap workload:
    with ``linger > 0`` the tail attach batch's timer expires during the
    drain, so the RPC round trip overlaps the PFS traffic)."""
    return WorkloadConfig(
        f"CKPT-W/{model}", model, "contig", None, n, 0, p, m, m, s,
        pfs_drain=True
    )


# ---------------------------------------------------------------------------
@dataclass
class WorkloadResult:
    config: WorkloadConfig
    phases: List[PhaseResult]
    verified_reads: int = 0
    rpc_counts: Dict[str, int] = field(default_factory=dict)

    def phase(self, name: str) -> PhaseResult:
        for ph in self.phases:
            if ph.name == name:
                return ph
        raise KeyError(name)

    @property
    def write_bandwidth(self) -> float:
        return self.phase("write").io_bandwidth

    @property
    def read_bandwidth(self) -> float:
        return self.phase("read").io_bandwidth


@lru_cache(maxsize=8)
def _random_deal(total: int, seed: int) -> tuple:
    """The seeded permutation of all written blocks, dealt to readers.

    Shuffled ONCE per (total, seed) — every reader of a random-pattern
    workload slices the same deal, instead of each rank re-shuffling the
    full block list (which made fig7's 2048-client rows O(readers x
    total) in `random.shuffle` alone)."""
    blocks = list(range(total))
    _random.Random(seed).shuffle(blocks)
    return tuple(blocks)


def _write_offsets(cfg: WorkloadConfig, rank: int) -> List[int]:
    if cfg.write_pattern == "contig":
        base = rank * cfg.m_w * cfg.s
        return [base + j * cfg.s for j in range(cfg.m_w)]
    if cfg.write_pattern == "strided":
        return [(j * cfg.writers + rank) * cfg.s for j in range(cfg.m_w)]
    raise ValueError(cfg.write_pattern)


def _read_offsets(cfg: WorkloadConfig, rank: int) -> List[int]:
    if cfg.read_pattern == "contig":
        base = rank * cfg.m_r * cfg.s
        return [base + j * cfg.s for j in range(cfg.m_r)]
    if cfg.read_pattern == "strided":
        return [(j * cfg.readers + rank) * cfg.s for j in range(cfg.m_r)]
    if cfg.read_pattern == "random":
        blocks = _random_deal(cfg.writers * cfg.m_w, cfg.seed)
        mine = blocks[rank * cfg.m_r : (rank + 1) * cfg.m_r]
        return [b * cfg.s for b in mine]
    if cfg.read_pattern == "hot":
        total = cfg.writers * cfg.m_w
        hot = max(1, min(cfg.hot_blocks, total))
        # hot_stride spaces the hot blocks ``stride`` blocks apart (a
        # NON-contiguous hot set; stride 1 = the contiguous head region).
        stride = max(1, cfg.hot_stride)
        while stride > 1 and (hot - 1) * stride >= total:
            stride //= 2  # clamp the hot set into the written file
        # Integer-combined seed: deterministic across processes (tuple
        # seeding would go through hash()).
        rng = _random.Random(cfg.seed * 1_000_003 + rank)
        return [
            (rng.randrange(hot) * stride if rng.random() < cfg.hot_frac
             else rng.randrange(total)) * cfg.s
            for _ in range(cfg.m_r)
        ]
    raise ValueError(cfg.read_pattern)


def _write_offset_cols(cfg: WorkloadConfig) -> list:
    """Round-major offset columns for the write phase.

    The regular patterns are arithmetic progressions per round-robin
    round — ``range`` objects extend into the program columns at C
    speed, skipping the per-rank offset lists entirely.  Irregular
    patterns fall back to the per-rank generator transposed."""
    W, s, m = cfg.writers, cfg.s, cfg.m_w
    if cfg.write_pattern == "contig":
        # offset(rank, round j) = rank*m*s + j*s
        return [range(j * s, j * s + W * m * s, m * s) for j in range(m)]
    if cfg.write_pattern == "strided":
        # offset(rank, round j) = (j*W + rank)*s
        return [range(j * W * s, (j * W + W) * s, s) for j in range(m)]
    offsets = [_write_offsets(cfg, r) for r in range(W)]
    return [[offsets[r][j] for r in range(W)] for j in range(m)]


def _read_offset_cols(cfg: WorkloadConfig) -> list:
    """Round-major offset columns for the read phase (see above); the
    random pattern slices the scaled block deal per round."""
    R, s, m = cfg.readers, cfg.s, cfg.m_r
    if cfg.read_pattern == "contig":
        return [range(j * s, j * s + R * m * s, m * s) for j in range(m)]
    if cfg.read_pattern == "strided":
        return [range(j * R * s, (j * R + R) * s, s) for j in range(m)]
    if cfg.read_pattern == "random":
        blocks = _random_deal(cfg.writers * cfg.m_w, cfg.seed)
        if len(blocks) < R * m:
            raise IndexError("read deal smaller than readers x m_r")
        ds = [b * s for b in blocks]
        # rank r's j-th read is deal[r*m + j]: round j is every m-th
        # scaled block starting at j, one per reader.
        return [ds[j:j + R * m:m] for j in range(m)]
    offsets = [_read_offsets(cfg, r) for r in range(R)]
    return [[offsets[r][j] for r in range(R)] for j in range(m)]


#: Write-phase tail sync op per model (posix attaches on every write —
#: no tail op).  These ride in the compiled program as control opcodes,
#: so they execute through the layer's own sync methods at exactly the
#: position the scalar loop runs them.
_WRITE_SYNC_OP = {"commit": opstream.OP_COMMIT,
                  "session": opstream.OP_SESSION_CLOSE,
                  "mpiio": opstream.OP_FILE_SYNC}


def compile_write_program(cfg: WorkloadConfig) -> opstream.OpProgram:
    """Compile the write phase's inner loop into a columnar op program:
    ``m_w`` round-robin rounds of per-rank writes, then the per-rank
    consistency sync op (commit / session_close / file_sync).  Client
    ids are writer ranks — the keys of the writer handle map."""
    prog = opstream.OpProgram(paths=(SHARED_FILE,))
    W, s = cfg.writers, cfg.s
    ranks = range(W)
    nw = W * cfg.m_w
    prog.op.extend([opstream.OP_WRITE] * nw)
    for col in _write_offset_cols(cfg):
        prog.client.extend(ranks)
        prog.offset.extend(col)
    prog.size.extend([s] * nw)
    prog.file.extend([0] * nw)
    sync = _WRITE_SYNC_OP.get(cfg.model)
    if sync is not None:
        prog.op.extend([sync] * W)
        prog.client.extend(ranks)
        prog.offset.extend([0] * W)
        prog.size.extend([0] * W)
        prog.file.extend([0] * W)
    return prog


def compile_read_program(cfg: WorkloadConfig) -> opstream.OpProgram:
    """Compile the read phase's inner loop: ``m_r`` round-robin rounds
    of per-reader reads, then the session-model closes.  Client ids are
    reader indices ``0..readers`` — the keys of the reader handle map
    (NOT BaseFS client ids, which are offset by ``cfg.writers``)."""
    prog = opstream.OpProgram(paths=(SHARED_FILE,))
    R, s = cfg.readers, cfg.s
    readers = range(R)
    nr = R * cfg.m_r
    prog.op.extend([opstream.OP_READ] * nr)
    for col in _read_offset_cols(cfg):
        prog.client.extend(readers)
        prog.offset.extend(col)
    prog.size.extend([s] * nr)
    prog.file.extend([0] * nr)
    if cfg.model == "session":
        prog.op.extend([opstream.OP_SESSION_CLOSE] * R)
        prog.client.extend(readers)
        prog.offset.extend([0] * R)
        prog.size.extend([0] * R)
        prog.file.extend([0] * R)
    return prog


def run_workload(cfg: WorkloadConfig, fs: Optional[BaseFS] = None,
                 hw: Optional[HardwareConstants] = None,
                 verify: bool = True, shards: Optional[int] = None,
                 batch: Optional[int] = None,
                 linger: Optional[float] = None,
                 adaptive: Optional[bool] = None,
                 materialize: Optional[bool] = None,
                 ack_window: Optional[int] = None,
                 timings: Optional[Dict[str, float]] = None,
                 tracer=None,
                 engine: Optional[str] = None,
                 faults=None,
                 bulk: Optional[bool] = None) -> WorkloadResult:
    """Execute ``cfg`` on a fresh BaseFS; return DES-priced phase results.

    The file system is purged before each run (paper §6.1): a fresh BaseFS
    per call unless the caller passes one in.  ``shards``/``batch``/
    ``linger``/``adaptive``/``materialize``/``ack_window`` override the
    process-wide :data:`TOPOLOGY` defaults for that fresh BaseFS (ignored
    when ``fs`` is supplied); ``None`` already means "use TOPOLOGY"
    inside ``BaseFS``.

    Writes carry :func:`pattern_extent` descriptors and reads are
    verified symbolically against them — zero byte materialization on
    the default (extent) data plane, real byte round-trips under
    ``materialize=True``.  ``timings``, if given, receives ``exec_s``
    (BaseFS execution), ``replay_s`` (DES pricing) and ``events``.
    ``engine`` selects the DES replay implementation — ``"scalar"``
    (reference) or ``"vector"`` (bitwise-identical results, faster at
    scale; see :meth:`repro_torch.core.costmodel.CostModel.replay`); ``None``
    uses the process-wide :data:`REPLAY` default.

    ``tracer`` (an :class:`repro_torch.analysis.trace.ExecutionTracer`)
    optionally lifts the run into the paper's formal execution for race
    analysis; the run itself is unchanged (the proxy only observes).

    ``faults`` (a :class:`repro_torch.core.faults.FaultSchedule`) injects the
    seeded fault plane — RPC drops with timeout/retry/backoff, shard-master
    crash/failover, slow shards — into the fresh BaseFS; ``None`` keeps the
    TOPOLOGY default (normally fault-free).  Ignored when ``fs`` is
    supplied (the caller's BaseFS already fixed its fault plane).

    ``bulk`` selects the execution mode: ``True`` compiles the phase
    inner loops into op programs (:func:`compile_write_program` /
    :func:`compile_read_program`) and submits them through the layer's
    ``run_ops`` bulk API; ``False`` runs the reference op-by-op loop.
    ``None`` uses the process-wide :data:`EXEC` default.  The recorded
    ledger — and therefore every DES result — is bitwise-identical
    either way.
    """
    t0 = _time.perf_counter()
    bulk_mode = (EXEC["mode"] == "bulk") if bulk is None else bulk
    if fs is None:
        fs = BaseFS(num_shards=shards, batch=batch, linger=linger,
                    adaptive=adaptive, materialize=materialize,
                    ack_window=ack_window, faults=faults)
    layer = make_fs(cfg.model, fs)
    if tracer is not None:
        layer = tracer.attach(layer)
    ledger = fs.ledger

    # ---- write phase ----------------------------------------------------
    # Opens (and the writers' session_open on the empty file) happen in
    # the setup region, OUTSIDE the timed phase — IOR-style methodology,
    # and the paper's own note that "session_open became a no-op" for the
    # empty file (§6.1.1).  commit/close/sync stay inside: they ARE the
    # consistency-model cost of the write path.
    handles: Dict[int, FileHandle] = {}
    if cfg.write_pattern:
        for rank in range(cfg.writers):
            node = rank // cfg.p
            fh = layer.open(rank, SHARED_FILE, node=node, tier=cfg.tier)
            handles[rank] = fh
            if cfg.model == "session":
                layer.session_open(fh)  # no-op query on the empty file
        ledger.mark_phase("write")
        # Interleave write ops round-robin over ranks: the DES reconstructs
        # true concurrency from per-client chains; round-robin issue also
        # exercises the server under the paper's concurrent arrival order.
        if bulk_mode:
            layer.run_ops(compile_write_program(cfg), handles,
                          payload_fn=pattern_extent)
        else:
            offsets = {r: _write_offsets(cfg, r) for r in range(cfg.writers)}
            for j in range(cfg.m_w):
                for rank in range(cfg.writers):
                    fh = handles[rank]
                    off = offsets[rank][j]
                    layer.seek(fh, off)
                    layer.write(fh, pattern_extent(off, cfg.s))
            for rank in range(cfg.writers):
                fh = handles[rank]
                if cfg.model == "commit":
                    layer.commit(fh)
                elif cfg.model == "session":
                    layer.session_close(fh)
                elif cfg.model == "mpiio":
                    layer.file_sync(fh)
                # posix: writes already attached.
        if cfg.pfs_drain:
            # Burst-buffer drain to the PFS INSIDE the write phase (no
            # barrier): a posix writer's tail attach batch stays open
            # across the drain, so with linger > 0 the DES's queue timer
            # expires mid-phase and the RPC overlaps the PFS traffic.
            for rank in range(cfg.writers):
                fh = handles[rank]
                fs.bfs_flush_file(fh.client, fh.bfs_handle)

    # ---- read phase ------------------------------------------------------
    verified = 0
    if cfg.read_pattern:
        ledger.mark_phase("read")
        rhandles: Dict[int, FileHandle] = {}
        for r in range(cfg.readers):
            cid = cfg.writers + r
            node = cfg.n_w + r // cfg.p
            fh = layer.open(cid, SHARED_FILE, node=node, tier=cfg.tier)
            rhandles[r] = fh
            if cfg.model == "session":
                layer.session_open(fh)
            elif cfg.model == "mpiio":
                layer.file_sync(fh)
        if bulk_mode:
            verified = layer.run_ops(
                compile_read_program(cfg), rhandles,
                expect_fn=pattern_extent if verify else None)
        else:
            roffsets = {r: _read_offsets(cfg, r) for r in range(cfg.readers)}
            for j in range(cfg.m_r):
                for r in range(cfg.readers):
                    fh = rhandles[r]
                    off = roffsets[r][j]
                    layer.seek(fh, off)
                    data = layer.read(fh, cfg.s)
                    if verify:
                        # Symbolic on the extent plane (descriptor
                        # compare, no materialization); byte compare in
                        # byte mode.
                        assert data == pattern_extent(off, cfg.s), (
                            f"{cfg.name}: read mismatch at offset {off}"
                        )
                        verified += 1
            for r in range(cfg.readers):
                if cfg.model == "session":
                    layer.session_close(rhandles[r])

    fs.drain()  # flush tail send-queue batches so the DES prices them
    t1 = _time.perf_counter()
    phases = CostModel(hw).replay(ledger, engine=engine or REPLAY["engine"])
    t2 = _time.perf_counter()
    if timings is not None:
        timings["exec_s"] = t1 - t0
        timings["replay_s"] = t2 - t1
        timings["events"] = ledger.n_events
        timings["exec_mode"] = "bulk" if bulk_mode else "scalar"
        timings["replay_engine"] = getattr(phases, "engine", "scalar")
        fb = getattr(phases, "fallback_reason", None)
        if fb is not None:
            timings["replay_fallback_reason"] = fb
    rpc_counts = {
        t: ledger.count(EventKind.RPC, t)
        for t in ("attach", "query", "detach", "stat", "migrate")
    }
    return WorkloadResult(cfg, phases, verified, rpc_counts)

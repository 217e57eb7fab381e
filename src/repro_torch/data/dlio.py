"""The LBANN "Preloaded" DL ingestion strategy (paper §6.3) — executable.

Each logical host preloads a disjoint shard of the training samples into
its node-local burst buffer (one file per host, written through the
consistency layer and published with commit / session_close).  At every
epoch a seeded random permutation deals samples evenly to all hosts; a
host reads its assigned samples — local or remote — through the layer.

Under commit consistency every sample read issues a query RPC; under
session consistency one ``session_open`` per (reader, source-file) pair
suffices for the whole epoch.  The paper's Fig. 6 gap is therefore
measured from the real RPC stream here, and the benchmark in
``benchmarks/fig6_dl.py`` prices it with the DES.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import ops as opstream
from repro_torch.core.basefs import BaseFS, EventKind
from repro_torch.core.consistency import FileHandle, make_fs

READER_BASE = 300_000


def _store_path(host: int) -> str:
    return f"/dl/shard_{host}.samples"


@dataclass
class EpochStats:
    epoch: int
    samples_read: int
    bytes_read: int
    local_reads: int
    remote_reads: int
    queries: int


class PreloadedStore:
    """Sharded sample store with per-epoch random global shuffling.

    ``samples`` may be real arrays (np.ndarray per sample, all equal
    nbytes) or ``None`` with ``sample_bytes`` set (synthetic benchmark
    mode — bytes are deterministic patterns, still fully verified).
    """

    def __init__(self, model: str, num_hosts: int, samples_per_host: int,
                 sample_bytes: int = 116 * 1024,
                 procs_per_host: int = 4,
                 fs: Optional[BaseFS] = None,
                 samples: Optional[List[np.ndarray]] = None,
                 tracer=None) -> None:
        self.fs = fs or BaseFS()
        self.layer = make_fs(model, self.fs)
        if tracer is not None:
            # Lift every layer call into the formal execution for race
            # analysis (repro_torch.analysis.trace); the run is unchanged.
            self.layer = tracer.attach(self.layer)
        self.model = model
        self.H = num_hosts
        self.P = procs_per_host
        self.n_local = samples_per_host
        self.total = num_hosts * samples_per_host
        self.samples = samples
        if samples is not None:
            assert len(samples) == self.total
            sample_bytes = samples[0].nbytes
            for s in samples:
                assert s.nbytes == sample_bytes, "equal-size samples required"
        self.sample_bytes = sample_bytes
        self._preloaded = False
        self._write_handles: Dict[int, FileHandle] = {}

    # ------------------------------------------------------------------
    def _sample_payload(self, idx: int):
        """Sample content: real bytes, or a zero-copy pattern extent in
        synthetic mode (read verification is then a descriptor compare)."""
        if self.samples is not None:
            return self.samples[idx].tobytes()
        from repro_torch.io.workloads import pattern_extent
        return pattern_extent(idx * self.sample_bytes, self.sample_bytes)

    def owner_host(self, idx: int) -> int:
        return idx // self.n_local

    def preload(self) -> None:
        """Phase 1: every host writes its shard and publishes it."""
        self.fs.ledger.mark_phase("preload")
        for h in range(self.H):
            fh = self.layer.open(h, _store_path(h), node=h)
            self._write_handles[h] = fh
            if self.model == "session":
                self.layer.session_open(fh)
            for j in range(self.n_local):
                self.layer.write(fh, self._sample_payload(h * self.n_local + j))
            if self.model == "commit":
                self.layer.commit(fh)
            elif self.model == "session":
                self.layer.session_close(fh)
            elif self.model == "mpiio":
                self.layer.file_sync(fh)
        self._preloaded = True

    # ------------------------------------------------------------------
    def epoch_assignment(self, epoch: int, seed: int = 0
                         ) -> List[List[int]]:
        """Random permutation dealt evenly to H*P reader processes."""
        idx = list(range(self.total))
        _random.Random(hash((seed, epoch)) & 0xFFFFFFFF).shuffle(idx)
        R = self.H * self.P
        per = self.total // R
        return [idx[r * per : (r + 1) * per] for r in range(R)]

    def run_epoch(self, epoch: int, seed: int = 0, verify: bool = True,
                  bulk: Optional[bool] = None) -> EpochStats:
        """Phase 2: every reader process fetches its assigned samples.

        ``bulk=True`` compiles each reader's sample stream into op
        programs (:mod:`repro_torch.core.ops`) submitted through the layer's
        ``run_ops`` bulk API, chunked at handle-open boundaries so
        every ``session_open``/``file_sync`` lands at exactly its
        scalar position — the recorded ledger is bitwise-identical to
        the per-op loop.  ``None`` follows the process-wide
        ``workloads.EXEC`` default.  Verification rides on a stateful
        ``expect_fn``: ``run_ops`` calls it exactly once per read, in
        program order, so an iterator over the chunk's expected
        payloads checks sample content without a per-file offset map.
        """
        assert self._preloaded, "call preload() first"
        if bulk is None:
            from repro_torch.io.workloads import EXEC
            bulk = EXEC["mode"] == "bulk"
        self.fs.ledger.mark_phase(f"epoch_{epoch}")
        assign = self.epoch_assignment(epoch, seed)
        R = self.H * self.P
        q0 = self.fs.ledger.count(EventKind.RPC, "query")
        stats = EpochStats(epoch, 0, 0, 0, 0, 0)
        # per-reader handle cache: one open (+session_open) per source file
        for r in range(R):
            host = r // self.P
            cid = READER_BASE + epoch * R + r
            handles: Dict[int, FileHandle] = {}
            prog: Optional[opstream.OpProgram] = None
            expected: List = []

            def _flush_chunk() -> None:
                nonlocal prog, expected
                if prog is None or not len(prog):
                    return
                it = iter(expected)
                self.layer.run_ops(
                    prog, handles,
                    expect_fn=((lambda off, size: next(it))
                               if verify else None))
                prog, expected = None, []

            for idx in assign[r]:
                src = self.owner_host(idx)
                if src not in handles:
                    # Chunk boundary: the open (and its session_open /
                    # file_sync) must record between the reads exactly
                    # where the scalar loop put it.
                    _flush_chunk()
                    fh = self.layer.open(cid, _store_path(src), node=host)
                    if self.model == "session":
                        self.layer.session_open(fh)
                    elif self.model == "mpiio":
                        self.layer.file_sync(fh)
                    handles[src] = fh
                off = (idx - src * self.n_local) * self.sample_bytes
                if bulk:
                    if prog is None:
                        prog = opstream.OpProgram()
                    prog.add(opstream.OP_READ, src, offset=off,
                             size=self.sample_bytes)
                    if verify:
                        expected.append(self._sample_payload(idx))
                else:
                    fh = handles[src]
                    self.layer.seek(fh, off)
                    data = self.layer.read(fh, self.sample_bytes)
                    if verify:
                        assert data == self._sample_payload(idx), (
                            f"sample {idx} corrupt under {self.model}")
                stats.samples_read += 1
                stats.bytes_read += self.sample_bytes
                if src == host:
                    stats.local_reads += 1
                else:
                    stats.remote_reads += 1
            _flush_chunk()
        self.fs.drain()  # flush tail send-queue batches before counting
        stats.queries = self.fs.ledger.count(EventKind.RPC, "query") - q0
        return stats

    # ------------------------------------------------------------------
    def read_sample(self, idx: int, reader_host: int = 0,
                    cid: Optional[int] = None) -> bytes:
        """Point read used by the training pipeline."""
        src = self.owner_host(idx)
        cid = cid if cid is not None else READER_BASE - 1 - reader_host
        fh = self.layer.open(cid, _store_path(src), node=reader_host)
        if self.model == "session":
            self.layer.session_open(fh)
        off = (idx - src * self.n_local) * self.sample_bytes
        self.layer.seek(fh, off)
        # The training pipeline consumes raw bytes: materialize here (the
        # lazy payload stays symbolic on the benchmark epoch path).
        return bytes(self.layer.read(fh, self.sample_bytes))

"""Distributed checkpoint manager over the paper's consistency layers.

Ported from ``repro.checkpoint.manager``, with the same protocol, file
names, client ids and write order, so a port state saves to the reference's
ledger, manifest and shard bytes (:mod:`repro_torch.checkpoint.serialization`
lays the port's per-layer tensors out as the reference's stacked tree).
:meth:`CheckpointManager.restore` returns a new state whose tensors own
their memory: the BaseFS data plane keeps the written ``bytes`` objects
themselves, and a restored tensor that viewed them would carry the next
in-place optimizer step into the stored checkpoint.

SCR-style multi-level checkpointing for sharded training state:

* **Level 1 (burst buffer)** — every logical host writes its row-range of
  each leaf into its own shard file through CommitFS or SessionFS; with
  ``partner=True`` an identical copy lands in the partner host's file
  (SCR "Partner" redundancy — survives a single node loss per group).
* **Level 2 (PFS)** — :meth:`flush` drains shard files to the underlying
  PFS (``bfs_flush_file``), surviving whole-job loss; :meth:`release`
  detaches burst-buffer ownership afterwards (cold-restart path).

Consistency protocol (the paper's MSC, enforced not assumed):
writers ``commit``/``session_close`` their shard **before** host 0 writes
and commits the MANIFEST; a restart opens the MANIFEST first, so the
manifest's happens-before edge transitively orders every shard write
before every restart read.  Under SessionFS a restart host performs ONE
``session_open`` query per source file; under CommitFS every read
queries — the measured RPC gap is the paper's Fig. 5 on real state.

Elastic restart: the manifest records the row partition, so a restart
with a different host count (or after a node failure, via the partner
copy) reads exactly the ranges it needs across shard files.

A sharded state (DTensor leaves, one process per rank) is saved as the
reference saves global arrays: every rank takes part in gathering each leaf
whole (:func:`repro_torch.checkpoint.serialization.iter_arrays`) and only
rank 0 writes, through its BaseFS and consistency layer, so the ledger, the
manifest and the bytes are exactly an unsharded save's.  Every rank keeps
the manifest.  A restore reads on rank 0 alone, and every rank gets its own
shards of each leaf on the template's placements.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.serialization import (
    DTYPES,
    deserialize_tree,
    is_sharded,
    iter_arrays,
    manifest_from_json,
    manifest_to_json,
    row_partition,
    tree_manifest,
)
from repro_torch.core.basefs import BaseFS
from repro_torch.core.consistency import FileHandle, make_fs

READER_BASE = 500_000  # restart processes get fresh client ids


def _shard_path(base: str, step: int, host: int, partner: bool = False) -> str:
    sfx = ".partner" if partner else ""
    return f"{base}/step_{step}/shard_{host}.bin{sfx}"


def _manifest_path(base: str, step: int) -> str:
    return f"{base}/step_{step}/MANIFEST"


class CheckpointManager:
    def __init__(self, model: str = "session", fs: Optional[BaseFS] = None,
                 num_hosts: int = 4, partner: bool = True,
                 base: str = "/ckpt") -> None:
        self.fs = fs or BaseFS()
        self.layer = make_fs(model, self.fs)
        self.model = model
        self.num_hosts = num_hosts
        self.partner = partner
        self.base = base
        self.manifests: Dict[int, dict] = {}
        # Save-time handles kept for level-2 flush / release: the local
        # interval map (write->buffer mapping) lives on the open file.
        self._handles: Dict[int, Dict[Any, FileHandle]] = {}

    # ------------------------------------------------------------------
    def _publish(self, fh: FileHandle) -> None:
        if self.model == "commit":
            self.layer.commit(fh)
        elif self.model == "session":
            self.layer.session_close(fh)
        elif self.model == "mpiio":
            self.layer.file_sync(fh)
        # posix: writes attach eagerly

    def _open_session(self, fh: FileHandle) -> None:
        if self.model == "session":
            self.layer.session_open(fh)
        elif self.model == "mpiio":
            self.layer.file_sync(fh)

    def partner_of(self, host: int) -> int:
        return (host + 1) % self.num_hosts

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> dict:
        """Write one checkpoint; returns the manifest.  Of a sharded tree,
        on every rank, rank 0 alone writing (module docstring)."""
        writer = not is_sharded(tree) or dist.get_rank() == 0
        H = self.num_hosts
        dtypes = {k: m["dtype"] for k, m in tree_manifest(tree).items()}
        manifest: dict = {"step": step, "num_hosts": H, "leaves": {}}

        # Host-major write order; the DES reconstructs real concurrency.
        offsets = {h: 0 for h in range(H)}
        handles: Dict[int, FileHandle] = {}
        phandles: Dict[int, FileHandle] = {}
        if writer:
            self.fs.ledger.mark_phase(f"ckpt_save_{step}")
        for h in range(H if writer else 0):
            handles[h] = self.layer.open(h, _shard_path(self.base, step, h),
                                         node=h)
            self._open_session(handles[h])
            if self.partner:
                # Partner copy lands on the partner's NODE (its burst buffer)
                # but is written by this host's rank group (SCR semantics).
                p = self.partner_of(h)
                phandles[h] = self.layer.open(
                    READER_BASE + 100_000 + h,
                    _shard_path(self.base, step, h, partner=True), node=p)
                self._open_session(phandles[h])

        # One leaf on the host at a time besides the bytes written: the
        # reference serializes the whole tree first, which costs the host
        # one more copy of the state.
        for path, arr in iter_arrays(tree):
            nrows = arr.shape[0] if arr.ndim > 0 else 1
            flat2d = arr.reshape(nrows, -1)
            rowbytes = flat2d[0:1].nbytes if nrows else 0
            parts = []
            for h, (rs, re) in enumerate(row_partition(nrows, H)):
                if re <= rs:
                    continue
                nbytes = (re - rs) * rowbytes
                if writer:
                    data = flat2d[rs:re].tobytes()
                    self.layer.write(handles[h], data)
                    if self.partner:
                        self.layer.write(phandles[h], data)
                parts.append({"host": h, "rows": [rs, re],
                              "offset": offsets[h], "nbytes": nbytes})
                offsets[h] += nbytes
            manifest["leaves"][path] = {
                "shape": list(arr.shape), "dtype": dtypes[path],
                "rowbytes": rowbytes, "parts": parts,
            }
        self.manifests[step] = manifest
        if not writer:
            return manifest

        for h in range(H):                       # publish shards FIRST
            self._publish(handles[h])
            if self.partner:
                self._publish(phandles[h])
        # ... THEN the manifest (the hb edge restart relies on).
        mfh = self.layer.open(0, _manifest_path(self.base, step), node=0)
        self._open_session(mfh)
        self.layer.write(mfh, manifest_to_json(manifest))
        self._publish(mfh)
        self._handles[step] = {**handles, "manifest": mfh}
        for h, pfh in phandles.items():
            self._handles[step][("partner", h)] = pfh
        return manifest

    # ------------------------------------------------------------------
    def read_manifest(self, step: int, reader: int = READER_BASE) -> dict:
        fh = self.layer.open(reader, _manifest_path(self.base, step),
                             node=0)
        self._open_session(fh)
        size = self.layer.stat_size(fh)
        self.layer.seek(fh, 0)
        # The read is a lazy payload; JSON decoding needs the real bytes.
        return manifest_from_json(bytes(self.layer.read(fh, size)))

    def restore(self, step: int, template: Any,
                num_hosts_new: Optional[int] = None,
                failed_hosts: Sequence[int] = ()) -> Any:
        """Rebuild the full tree; reads go through the consistency layer.

        Returns a new state shaped like ``template`` (a new ``Transformer``
        and new tensors on the template's devices); the template is not
        touched.

        ``num_hosts_new`` simulates elastic restart (different reader
        count — purely a read-pattern change); ``failed_hosts`` forces
        those source shards to be served from the partner copy.

        A sharded template is restored on every rank at once: rank 0 reads,
        and each rank gets its shards (module docstring).
        """
        if is_sharded(template) and dist.get_rank() != 0:
            return deserialize_tree(template, None)
        Hn = num_hosts_new or self.num_hosts
        self.fs.ledger.mark_phase(f"ckpt_restore_{step}")
        manifest = self.read_manifest(step)
        failed = set(failed_hosts)

        # One reader client per restart host; each opens each source file
        # at most once per session (this is where session >> commit).
        handles: Dict[Tuple[int, int, bool], FileHandle] = {}

        def get_handle(reader_host: int, src_host: int, partner: bool
                       ) -> FileHandle:
            key = (reader_host, src_host, partner)
            if key not in handles:
                fh = self.layer.open(
                    READER_BASE + reader_host,
                    _shard_path(self.base, step, src_host, partner=partner),
                    node=src_host if not partner
                    else self.partner_of(src_host))
                self._open_session(fh)
                handles[key] = fh
            return handles[key]

        arrays: Dict[str, torch.Tensor] = {}
        for path, meta in manifest["leaves"].items():
            shape, dtype = tuple(meta["shape"]), DTYPES[meta["dtype"]]
            nrows = shape[0] if shape else 1
            buf = np.empty((nrows, meta["rowbytes"]), np.uint8)
            new_parts = row_partition(nrows, Hn)
            for rh, (nrs, nre) in enumerate(new_parts):
                for part in meta["parts"]:
                    rs, re = part["rows"]
                    lo, hi = max(rs, nrs), min(re, nre)
                    if hi <= lo:
                        continue
                    src = part["host"]
                    use_partner = src in failed
                    if use_partner and not self.partner:
                        raise RuntimeError(
                            f"host {src} failed and no partner copy exists")
                    fh = get_handle(rh, src, use_partner)
                    off = part["offset"] + (lo - rs) * meta["rowbytes"]
                    self.layer.seek(fh, off)
                    data = self.layer.read(fh, (hi - lo) * meta["rowbytes"])
                    # Checkpoint state round-trips REAL bytes: materialize
                    # the lazy payload at the consumer.
                    buf[lo:hi] = np.frombuffer(
                        bytes(data), np.uint8).reshape(hi - lo,
                                                       meta["rowbytes"])
            # buf owns its bytes (the reads above copied into it).
            arrays[path] = torch.from_numpy(buf).view(dtype).reshape(shape)
        return deserialize_tree(template, arrays)

    # ------------------------------------------------------------------
    def flush(self, step: int) -> None:
        """Level-2: drain shard files (and manifest) to the underlying PFS."""
        self.fs.ledger.mark_phase(f"ckpt_flush_{step}")
        for fh in self._handles[step].values():
            self.fs.bfs_flush_file(fh.client, fh.bfs_handle)

    def release(self, step: int) -> None:
        """Detach burst-buffer ownership (cold restart reads hit the PFS).

        Requires a prior :meth:`flush` if the data must remain readable
        (Table 5: detach without flush discards visibility).
        """
        for fh in self._handles[step].values():
            self.fs.bfs_detach_file(fh.client, fh.bfs_handle)

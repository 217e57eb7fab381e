"""Multi-pod dry run: build every (arch x shape x mesh) cell's step on meta
tensors and count what one device does.

Ported from ``repro.launch.dryrun``, whose CLI this is.  For each live cell
(:func:`repro_torch.models.config.shapes_for`) it

1. starts a fake process group of 256 or 512 ranks in this process
   (:func:`repro_torch.launch.mesh.fake_world`): rank 0's view, with every
   collective issued and none carried out;
2. builds the production mesh, (16, 16) ("data", "model") single-pod or
   (2, 16, 16) ("pod", "data", "model") multi-pod, and the arch's logical
   sharding rules on it;
3. places the abstract state, batch and cache on their placements as meta
   DTensors (:func:`input_specs`): nothing is allocated and nothing is whole;
4. runs the port's own step, ``make_train_step``, ``make_prefill`` or
   ``make_serve_step``, eagerly under :class:`repro_torch.launch.hlostats.StepCounter`,
   which counts rank 0's local dot FLOPs, op bytes, collectives by kind and
   the hand-written kernels' work (their wrappers launch nothing on meta
   tensors and record it);
5. writes a JSON artifact under ``artifacts/dryrun_torch/`` with those
   counts, the per-device state, batch and cache bytes (:func:`_sharded_bytes`,
   the reference's), the bytes autograd saves for the backward (train
   cells) and whether state, batch, cache and saved bytes fit one H100's
   80 GB.

PyTorch has no partitioner to compile, so where the reference records
``lower_s`` / ``compile_s``, ``memory_analysis`` and the HLO's costs, this
records ``build_s`` (placing the inputs), ``trace_s`` (running the step),
``saved_bytes_per_device``, ``flops_per_device`` (dot FLOPs plus the
kernels' FLOPs; attention counts only the (query, key) pairs its mask lets
through, as the kernel does, and ``dense_flops_per_device`` counts all of
them) and ``op_bytes_per_device`` (bytes every operation reads and writes,
unfused: an upper bound on HBM traffic).

Usage::

    python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
    python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
CARD_BYTES = 80 * 10 ** 9          # one H100's HBM
SKIP_REASON = ("long_500k needs sub-quadratic decode "
               "(full-attention arch; DESIGN.md skip list)")

# A mesh's axis names and sizes, enough to resolve placements without a
# process group.
MeshShape = namedtuple("MeshShape", ["mesh_dim_names", "shape"])


_meta_lib = None


def _meta_equal() -> None:
    """Give ``aten::equal`` a meta kernel in this process: DTensor's
    masked-partial embedding (a vocab-sharded table) compares its cached
    mask with ``torch.equal``, which has none; of meta tensors only the
    shapes can be compared."""
    global _meta_lib
    if _meta_lib is None:
        import torch
        _meta_lib = torch.library.Library("aten", "IMPL")
        _meta_lib.impl("equal", lambda a, b: a.shape == b.shape, "Meta")


def _artifact_path(arch: str, shape: str, mesh_kind: str) -> str:
    safe = arch.replace("/", "_").replace(".", "_")
    return os.path.abspath(
        os.path.join(ARTIFACT_DIR, f"{safe}__{shape}__{mesh_kind}.json"))


def production_shape(multi_pod: bool) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


# ---------------------------------------------------------------------------
# input_specs -- meta stand-ins for every model input
# ---------------------------------------------------------------------------
def input_specs(cfg, cell, mesh=None, rules=None) -> Tuple[tuple, Dict[str, Any]]:
    """Abstract (args, kwargs) for the cell's step function, on
    ``device="meta"``; with a mesh, meta DTensors on their placements.

    train:    (state, batch)                      -- batch = tokens/labels(+modality)
    prefill:  (model, batch)                      -- tokens(+frames|patches)
    decode:   (model, cache, tokens(B,1), index)  -- one new token

    The port's state and serving functions hold the parameters in a
    ``Transformer``; the decode position is a Python int (the ring slot is
    chosen on the host), here the cache's last slot."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.models.frontends import extra_inputs
    from repro_torch.models.transformer import Transformer

    B, S = cell.global_batch, cell.seq_len
    sharded = mesh is not None
    if cell.mode == "train":
        if sharded:
            return (M.sharded_abstract_state(cfg, mesh, rules),
                    M.distribute_batch(M.batch_abstract(cfg, cell), mesh, rules)), {}
        state = M.abstract_state(cfg)
        state["params"] = Transformer(cfg, device="meta").requires_grad_(True)
        return (state, M.batch_abstract(cfg, cell)), {}
    model = (M.sharded_abstract_params(cfg, mesh, rules) if sharded
             else Transformer(cfg, device="meta"))
    if cell.mode == "prefill":
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
        batch.update(extra_inputs(cfg, B, None, device="meta"))
        if sharded:
            batch = M.distribute_batch(batch, mesh, rules)
        return (model, batch), {}
    if cell.mode == "decode":
        tok = {"tokens": torch.empty((B, 1), dtype=torch.int32, device="meta")}
        if sharded:
            cache = M.sharded_abstract_cache(model, cell, mesh, rules)
            tok = M.distribute_batch(tok, mesh, rules)
        else:
            cache = model.init_cache(B, S)
        return (model, cache, tok["tokens"], S - 1), {}
    raise ValueError(cell.mode)


def _zip_leaves(tree, placements) -> Iterator[Tuple[Any, tuple]]:
    """(tensor, placements) pairs of matching trees; the placements tree's
    leaves are tuples of ``Placement``, its keys those of the tensors'."""
    from torch import nn
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(placements, Mapping):
        for k in placements:
            yield from _zip_leaves(tree[k], placements[k])
    elif isinstance(placements, list):
        for t, p in zip(tree, placements):
            yield from _zip_leaves(t, p)
    else:
        yield tree, placements


def _sharded_bytes(abstract_tree, placements_tree, mesh) -> int:
    """Max per-device bytes of an abstract tree at its placements (one
    tuple of ``Placement`` per tensor, as ``resolve_tree`` gives them)."""
    from torch.distributed.tensor import Shard
    sizes = tuple(mesh.shape)
    total = 0
    for arr, pl in _zip_leaves(abstract_tree, placements_tree):
        nshards = 1
        for m, p in enumerate(pl):
            if isinstance(p, Shard):
                nshards *= sizes[m]
        total += arr.numel() * arr.element_size() // max(nshards, 1)
    return total


def cell_bytes(cfg, cell, mesh, rules) -> Dict[str, int]:
    """Per-device state, batch (train) and cache (serving) bytes of a cell,
    from the abstract trees and their resolved placements, as the
    reference's dry run records them.  ``mesh`` may be a :class:`MeshShape`."""
    from repro_torch.launch import mesh as M
    if cell.mode == "train":
        return {"state_bytes_per_device": _sharded_bytes(
                    M.abstract_state(cfg), M.state_shardings(cfg, mesh, rules), mesh),
                "batch_bytes_per_device": _sharded_bytes(
                    M.batch_abstract(cfg, cell),
                    M.batch_shardings(cfg, cell, mesh, rules), mesh)}
    return {"state_bytes_per_device": _sharded_bytes(
                M.abstract_params(cfg), M.params_shardings(cfg, mesh, rules), mesh),
            "cache_bytes_per_device": _sharded_bytes(
                M.cache_abstract(cfg, cell), M.cache_shardings(cfg, cell, mesh, rules),
                mesh)}


def _local_bytes(tree) -> int:
    """Bytes of the local shards of a tree of DTensors (and tensors)."""
    import torch
    from torch import nn
    from torch.distributed.tensor import DTensor
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, Mapping):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree._local_tensor if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape: str, mesh_kind: str,
             verbose: bool = True, cfg=None, mesh_shape: Optional[MeshShape] = None,
             by_op: bool = False, cell=None) -> Dict[str, Any]:
    """One cell's artifact record.  ``cfg``, ``mesh_shape`` and ``cell`` (a
    ``ShapeCell``) replace the arch's config, the production mesh and the
    named shape (the tests' small cells).  The
    record splits the FLOPs and wire bytes by operation (``by_op``); with
    ``by_op=True`` also by the line of the package that issued each
    (``by_caller``, slower: anomaly mode keeps every node's forward
    traceback), and ``verbose`` prints both splits' top 20."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import hlostats
    from repro_torch.launch import mesh as M
    from repro_torch.models.config import shapes_for
    from repro_torch.models.sharding import active_rules, rules_for
    from repro_torch.serve.decode import make_prefill, make_serve_step
    from repro_torch.train.train_step import make_train_step

    cfg = cfg or get_config(arch)
    cells = {c.name: c for c in shapes_for(cfg)}
    if cell is None and shape not in cells:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "skipped", "reason": SKIP_REASON}
    cell = cell or cells[shape]
    multi = mesh_kind == "multi"
    ms = mesh_shape or production_shape(multi)
    n_dev = 1
    for d in ms.shape:
        n_dev *= d
    M.fake_world(n_dev)
    _meta_equal()
    mesh = M.make_mesh(tuple(ms.shape), tuple(ms.mesh_dim_names), "cpu")
    rules = rules_for(cfg.policy, "pod" in ms.mesh_dim_names, fsdp=cfg.fsdp)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "mode": cell.mode,
        "devices": n_dev, "mesh_shape": list(ms.shape),
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "params_total": cfg.params_total(),
        "params_active": cfg.params_active(),
    }
    rec.update(cell_bytes(cfg, cell, mesh, rules))

    t0 = time.time()
    args, _ = input_specs(cfg, cell, mesh, rules)
    placed = {"train": ("state_bytes_per_device", args[0]),
              "prefill": ("state_bytes_per_device", args[0]),
              "decode": ("cache_bytes_per_device", args[1])}[cell.mode]
    if _local_bytes(placed[1]) != rec[placed[0]]:
        raise AssertionError(f"{placed[0]}: the placed shards hold "
                             f"{_local_bytes(placed[1])} bytes, the placements "
                             f"{rec[placed[0]]}")
    rec["build_s"] = round(time.time() - t0, 2)
    counter, saved = hlostats.StepCounter(by_caller=by_op), hlostats.SavedBytes()
    t1 = time.time()
    if cell.mode == "train":
        step = make_train_step(cfg, M.opt_for(cfg), num_microbatches=cfg.microbatches)
        with counter, saved(), active_rules(rules, mesh):
            step(*args)
        # Each microbatch's graph is freed after its backward: one
        # microbatch's saved tensors are the peak.
        rec["saved_bytes_per_device"] = saved.bytes // cfg.microbatches
        rec["tokens"] = cell.global_batch * cell.seq_len
        rec["flops_factor"] = 3  # fwd + bwd(2x)
    elif cell.mode == "prefill":
        model, batch = args
        pf = make_prefill(model, max_len=cell.seq_len)
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        with counter, torch.no_grad(), active_rules(rules, mesh):
            pf(batch["tokens"], **extras)
        rec["tokens"] = cell.global_batch * cell.seq_len
        rec["flops_factor"] = 1  # fwd only
    else:  # decode
        model, cache, tok, index = args
        with counter, torch.no_grad(), active_rules(rules, mesh):
            make_serve_step(model)(cache, tok, index)
        rec["tokens"] = cell.global_batch  # one token per sequence
        rec["flops_factor"] = 1
    rec["trace_s"] = round(time.time() - t1, 2)

    coll = counter.collectives
    rec["collectives"] = {
        "wire_bytes_per_device": coll.wire_bytes,
        "payload_bytes": coll.payload_bytes,
        "by_kind": coll.by_kind,
        "count": coll.count,
        "count_by_kind": counter.calls,
    }
    tot = counter.totals()
    rec["flops_per_device"] = tot["flops"]
    rec["dense_flops_per_device"] = tot["dense_flops"]
    rec["op_bytes_per_device"] = tot["bytes"]
    rec["kernels"] = {name: {"flops": c["flops"], "bytes": c["bytes"],
                             "launches": c["launches"]}
                      for name, c in counter.kernels.items()}
    rec["by_op"] = counter.by_op
    if by_op:
        rec["by_caller"] = counter.by_caller
    held = sum(rec.get(k, 0) for k in (
        "state_bytes_per_device", "batch_bytes_per_device",
        "cache_bytes_per_device", "saved_bytes_per_device"))
    rec["fits_80gb"] = held <= CARD_BYTES
    rec["status"] = "ok"

    if verbose:
        print(f"== {arch} / {shape} / {mesh_kind} "
              f"({cell.mode}, {n_dev} devices) ==")
        print(f"  build {rec['build_s']}s  trace {rec['trace_s']}s")
        print(f"  state/device: {rec['state_bytes_per_device'] / 2**30:.3f}GiB"
              + (f"  cache/device: {rec['cache_bytes_per_device'] / 2**30:.3f}GiB"
                 if "cache_bytes_per_device" in rec else "")
              + (f"  saved/device: {rec['saved_bytes_per_device'] / 2**30:.3f}GiB"
                 if "saved_bytes_per_device" in rec else "")
              + f"  fits 80 GB: {rec['fits_80gb']}")
        print(f"  FLOPs/device: {rec['flops_per_device']:.3e} (dense "
              f"{rec['dense_flops_per_device']:.3e})")
        print(f"  op bytes/device (unfused): {rec['op_bytes_per_device']:.3e}")
        print("  kernels: " + json.dumps(
            {k: f"{v['launches']} launches, {v['flops']:.2e} flops"
             for k, v in rec["kernels"].items()}))
        print("  collective wire bytes/device: "
              f"{coll.wire_bytes:.3e}  by kind: "
              + json.dumps({k: f"{v:.2e}" for k, v in coll.by_kind.items()}))
        if by_op:
            _print_top(counter)
    return rec


def _print_top(counter, n: int = 20) -> None:
    """The top ``n`` entries of each split by dense FLOPs and by wire bytes."""
    for split in ("by_op", "by_caller"):
        for key in ("dense_flops", "wire_bytes"):
            print(f"  top {n} {split} by {key}:")
            for name, e in counter.top(split, key, n):
                if e[key]:
                    print(f"    {e[key]:.3e}  {name}")


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------
def all_cells():
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.config import ALL_SHAPES
    for arch in ARCHS:
        for cell in ALL_SHAPES:
            yield arch, cell.name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell in subprocesses")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells that already have artifacts")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all, cells run at once (one subprocess each)")
    ap.add_argument("--by-op", action="store_true",
                    help="also split FLOPs and wire bytes by the issuing line "
                         "and print the top 20 of each split")
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape in all_cells():
            print(f"{arch:24s} {shape}")
        return 0

    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        todo = [(arch, shape, mk) for arch, shape in all_cells() for mk in meshes]
        if not args.force:
            for cell in [c for c in todo if os.path.exists(_artifact_path(*c))]:
                print(f"skip (exists): {'/'.join(cell)}")
                todo.remove(cell)

        def one(cell):
            arch, shape, mk = cell
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mk]
            if args.by_op:
                cmd.append("--by-op")
            t0 = time.time()
            r = subprocess.run(cmd, timeout=args.timeout, capture_output=True,
                               text=True)
            print(f">>> {arch}/{shape}/{mk}\n{r.stdout}{r.stderr[-2000:] if r.returncode else ''}"
                  f"<<< rc={r.returncode} {time.time()-t0:.0f}s", flush=True)
            return r.returncode

        with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
            rcs = list(pool.map(one, todo))
        failures = [c for c, rc in zip(todo, rcs) if rc != 0]
        if failures:
            print("FAILED cells:", failures)
            return 1
        print("all cells done")
        return 0

    assert args.arch and args.shape, "--arch and --shape (or --all)"
    rc = 0
    for mk in meshes:
        path = _artifact_path(args.arch, args.shape, mk)
        try:
            rec = run_cell(args.arch, args.shape, mk, by_op=args.by_op)
        except Exception as e:  # record the failure as an artifact too
            rec = {"arch": args.arch, "shape": args.shape, "mesh": mk,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(rec["traceback"], file=sys.stderr)
            rc = 1
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"artifact: {path}")
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""Production meshes + sharding binding for every (arch x shape) cell.

Ported from ``repro.launch.mesh``.  :func:`make_production_mesh` is a
FUNCTION (never a module constant), so importing this module touches no
process group; it builds a ``DeviceMesh`` over the process group that the
caller has started (``torch.distributed.init_process_group``, e.g. from the
torchrun environment).

Mesh shapes: single pod (16, 16) = 256 ranks ("data", "model"); multi-pod
(2, 16, 16) = 512 ranks ("pod", "data", "model").  The pod axis composes
with data parallelism.  :func:`fake_world` starts a fake process group of
that many ranks in one process (the dry run: rank 0's view, with every
collective issued and none carried out), over which a ``"cpu"`` mesh is
built.

The abstract state, batch and cache are the real modules and tensors built
on ``device="meta"`` (the reference's ``jax.eval_shape``); the
``*_shardings`` functions return trees of DTensor placements (the
reference's ``NamedSharding`` trees) and :func:`sharded_train_state` /
:func:`distribute_batch` place a real state or batch on the mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Placement, Replicate

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.models.frontends import extra_inputs
from repro_torch.models.sharding import (P, Rules, active_rules,
                                         distribute_model, distribute_tree,
                                         resolve_tree, rules_for,
                                         use_sync_gloo_all_gather)
from repro_torch.train.optimizer import AdamWConfig, adamw_init, opt_state_specs


def fake_world(n: int) -> None:
    """Start a fake process group of ``n`` ranks in this process, as rank 0:
    collectives are issued and return at once without moving data, so what
    runs is rank 0's local work.  A fake group already started is replaced;
    a real one is refused (the group is process-wide)."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake":
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    if dist.is_initialized():
        raise RuntimeError(
            f"fake_world({n}): this process already has a "
            f"{dist.get_backend()} process group of {dist.get_world_size()} "
            "ranks; a fake group needs a process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the started process
    group.  On a CUDA mesh over gloo (several ranks on one card) the
    functional all-gather goes through the blocking one
    (:func:`repro_torch.models.sharding.use_sync_gloo_all_gather`); a
    ``"cpu"`` mesh over gloo or over :func:`fake_world` needs nothing."""
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    if (device_type == "cuda"
            and torch.distributed.get_backend() == "gloo"):
        use_sync_gloo_all_gather()
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def arch_rules(cfg: ModelConfig, multi_pod: bool) -> Rules:
    return rules_for(cfg.policy, multi_pod, fsdp=cfg.fsdp)


def opt_for(cfg: ModelConfig) -> AdamWConfig:
    return AdamWConfig(state_dtype=cfg.opt_state_dtype)


# ---------------------------------------------------------------------------
# Abstract state/batch + bound shardings
# ---------------------------------------------------------------------------
def abstract_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    return dict(T.Transformer(cfg, device="meta").named_parameters())


def abstract_state(cfg: ModelConfig) -> Dict[str, Any]:
    params = abstract_params(cfg)
    return {"params": params, "opt": adamw_init(params, opt_for(cfg)),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def state_spec_tree(cfg: ModelConfig) -> Dict[str, Any]:
    pspec = T.param_specs(cfg)
    return {"params": pspec, "opt": opt_state_specs(pspec), "step": P()}


def params_shardings(cfg: ModelConfig, mesh, rules: Rules):
    return resolve_tree(T.param_specs(cfg), abstract_params(cfg), rules, mesh)


def state_shardings(cfg: ModelConfig, mesh, rules: Rules):
    return resolve_tree(state_spec_tree(cfg), abstract_state(cfg), rules, mesh)


def _batch_specs(batch: Mapping[str, torch.Tensor]) -> Dict[str, P]:
    return {k: P("batch", *([None] * (v.ndim - 1))) for k, v in batch.items()}


def batch_abstract(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    B, S = cell.global_batch, cell.seq_len
    out = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta"),
           "labels": torch.empty((B, S), dtype=torch.int32, device="meta")}
    out.update(extra_inputs(cfg, B, None, device="meta"))   # frames / patches
    return out


def batch_shardings(cfg: ModelConfig, cell: ShapeCell, mesh, rules: Rules):
    ab = batch_abstract(cfg, cell)
    return resolve_tree(_batch_specs(ab), ab, rules, mesh)


def cache_abstract(cfg: ModelConfig, cell: ShapeCell):
    return T.Transformer(cfg, device="meta").init_cache(cell.global_batch,
                                                       cell.seq_len)


def cache_shardings(cfg: ModelConfig, cell: ShapeCell, mesh, rules: Rules):
    return resolve_tree(T.cache_specs(cfg), cache_abstract(cfg, cell), rules,
                        mesh)


def replicated(mesh) -> Tuple[Placement, ...]:
    return (Replicate(),) * len(mesh.mesh_dim_names)


# ---------------------------------------------------------------------------
# Placing a real state / batch (the reference's jit in_shardings)
# ---------------------------------------------------------------------------
def sharded_train_state(model: T.Transformer, cfg: ModelConfig,
                        opt: AdamWConfig, mesh, rules: Rules) -> Dict[str, Any]:
    """A fresh train state around ``model`` (the same whole model on every
    rank): its parameters, with grad on, become DTensors on their resolved
    placements in place, and the zero moments are made on the same shards,
    never whole."""
    distribute_model(model.requires_grad_(True), T.param_specs(cfg), rules, mesh)
    return {"params": model,
            "opt": adamw_init(dict(model.named_parameters()), opt),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def distribute_batch(batch: Mapping[str, torch.Tensor], mesh,
                     rules: Rules) -> Dict[str, torch.Tensor]:
    """A batch (the same whole batch on every rank) sharded over its batch
    dim.  A meta batch gives meta DTensors."""
    return distribute_tree(dict(batch), _batch_specs(batch), rules, mesh)


def sharded_abstract_params(cfg: ModelConfig, mesh, rules: Rules) -> T.Transformer:
    """A model on ``device="meta"`` whose parameters are meta DTensors on
    their resolved placements (serving)."""
    return distribute_model(T.Transformer(cfg, device="meta"), T.param_specs(cfg),
                            rules, mesh)


def sharded_abstract_state(cfg: ModelConfig, mesh, rules: Rules) -> Dict[str, Any]:
    """The train state on ``device="meta"``: parameters (grad on) and
    moments as meta DTensors on their placements."""
    return sharded_train_state(T.Transformer(cfg, device="meta"), cfg,
                               opt_for(cfg), mesh, rules)


def sharded_abstract_cache(model: T.Transformer, cell: ShapeCell, mesh,
                           rules: Rules):
    """The cell's serving cache as meta DTensors on its placements."""
    with active_rules(rules, mesh):
        return model.init_cache(cell.global_batch, cell.seq_len)

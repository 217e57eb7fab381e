"""AdamW with global-norm clipping and a state-dtype policy.

Ported from ``repro.train.optimizer``.  Parameters, gradients and moments
are mappings from the port's parameter names (``Transformer``'s
``named_parameters``) to tensors.  Unlike the reference's pure functions,
:func:`adamw_update` writes the new parameters and moments in place, which
saves a copy of the model and of both moments on the card.
:func:`opt_state_specs` shards the moments exactly like the parameters.
Under a mesh, parameters, gradients and moments are DTensors on the same
placements (the train step pins the gradients there); the update runs on
each rank's local shards and the global norm sums the shards' squares over
the mesh.

Weight decay is decoupled and applied to leaves with ``ndim >= 2``, the
reference's "matrices only".  The port's leaves are per layer, so its norm
scales and biases are 1-d and never decayed.  The reference stacks each
block's leaves along ``n_super``, which makes those vectors 2-d there, so it
decays them in ``blocks`` (but not in ``rem{i}`` or ``final_norm``); the port
does not copy that (ROADMAP.md §3, "Defects found in the reference").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels import ops
from repro_torch.models.sharding import P

Tree = Mapping[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32   # bf16 for llama3-405b (memory budget)


# Elements of a leaf that update_in_slices updates at once.
SLICE = 1 << 26


def adamw_init(params: Tree, opt: AdamWConfig) -> Dict[str, Any]:
    """Zero moments in ``opt.state_dtype`` (DTensors on a DTensor
    parameter's shards) and a step count of 0 (int32), on the parameters'
    device."""
    device = next(iter(params.values())).device
    return {
        "m": {n: torch.zeros_like(p, dtype=opt.state_dtype) for n, p in params.items()},
        "v": {n: torch.zeros_like(p, dtype=opt.state_dtype) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def opt_state_specs(param_specs: Mapping[str, P]) -> Dict[str, Any]:
    """The moments shard like the parameters; the step is replicated."""
    return {"m": param_specs, "v": param_specs, "step": P()}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the f32 sum of squares.  DTensor
    leaves: each rank sums the squares of its shards, each divided by the
    number of ranks that hold the same shard, and an all-reduce over each
    mesh dim in turn adds them up; the result is a plain tensor, the same
    on every rank."""
    leaves = list(tree.values())
    if not isinstance(leaves[0], DTensor):
        return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in leaves))
    mesh = leaves[0].device_mesh
    total = 0
    for x in leaves:
        copies = 1
        for m, pl in enumerate(x.placements):
            if not pl.is_shard():
                if not isinstance(pl, Replicate):
                    raise ValueError(f"global_norm: a leaf at {x.placements}")
                copies *= mesh.size(m)
        total = total + torch.sum(x.to_local().float() ** 2) / copies
    for m in range(mesh.ndim):
        dist.all_reduce(total, group=mesh.get_group(m))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Tree, state: Dict[str, Any], params: Tree,
                 opt: AdamWConfig
                 ) -> Tuple[Tree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Writes the new parameters into ``params`` and the
    new moments into ``state["m"]`` / ``state["v"]`` in place, and returns
    ``(params, {"m", "v", "step": step + 1}, {"grad_norm", "clip"})``.

    The arithmetic is the reference's, in f32: the clip factor
    ``min(1, grad_clip / max(|g|, 1e-12))`` and the bias corrections
    ``1 - b**step`` are f32 tensors, not Python floats.  It is elementwise,
    and each leaf goes through :func:`repro_torch.kernels.ops.adamw`, which
    takes one of three paths by the device its (local) tensors are on:

    * CUDA: one launch of the fused kernel
      (:func:`repro_torch.kernels.adamw.adamw_cuda`), which reads p, g, m
      and v once and writes p, m and v once, with the slice loop's bits;
    * meta (the dry run): the same wrapper, which launches nothing and
      records the kernel's work;
    * CPU: :func:`update_in_slices`, the plain version."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    stepf = step.float()
    f32 = dict(dtype=torch.float32, device=gnorm.device)
    bc1 = 1 - torch.tensor(opt.b1, **f32) ** stepf
    bc2 = 1 - torch.tensor(opt.b2, **f32) ** stepf
    hyper = dict(lr=opt.lr, b1=opt.b1, b2=opt.b2, eps=opt.eps,
                 weight_decay=opt.weight_decay)
    for name, leaf in params.items():
        decay = leaf.ndim >= 2           # decoupled weight decay, matrices only
        quad = (leaf, grads[name], state["m"][name], state["v"][name])
        if isinstance(leaf, DTensor):
            if len({tuple(t.placements) for t in quad}) != 1:
                raise ValueError(f"adamw_update: {name}: parameter, gradient "
                                 "and moments on different placements "
                                 f"{[tuple(t.placements) for t in quad]}")
            quad = tuple(t.to_local() for t in quad)
        ops.adamw(*quad, clip, bc1, bc2, **hyper, decay=decay)
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "clip": clip}


def update_in_slices(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, clip: torch.Tensor, bc1: torch.Tensor,
                     bc2: torch.Tensor, *, lr: float, b1: float, b2: float,
                     eps: float, weight_decay: float, decay: bool) -> None:
    """One leaf's AdamW step in PyTorch's elementwise ops, in place, in
    slices of at most ``SLICE`` elements: the f32 temporaries of a
    256000 x 4096 embedding table would otherwise take about 20 GB beside
    the state.  The plain version of the fused kernel, with its signature."""
    flat = (p.view(-1), g.reshape(-1), m.view(-1), v.view(-1))
    for lo in range(0, flat[0].numel(), SLICE):
        p, g, m, v = (t[lo:lo + SLICE] for t in flat)
        gf = g.float() * clip
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        delta = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
        if decay:
            delta = delta + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)

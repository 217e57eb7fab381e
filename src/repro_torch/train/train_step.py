"""The train step: microbatched gradient accumulation + AdamW.

Ported from ``repro.train.train_step``.  ``make_train_step(cfg, opt, M)``
returns ``train_step(state, batch) -> (state, metrics)``.  The state is
``{"params": Transformer, "opt": adamw state, "step": int32 tensor}``; the
step updates the model's parameters and the moments in place (see
:func:`repro_torch.train.optimizer.adamw_update`) and returns the same
objects.

* The model forward checkpoints each super-block (``cfg.remat``), so peak
  activation memory is one super-block of one microbatch plus the saved
  block inputs.
* With M > 1 the batch is split contiguously into M microbatches, as the
  reference's reshape does; gradients accumulate in f32 divided by M, and
  the loss and CE by M.  The reference checkpoints the microbatch body of
  its scan; here each microbatch's graph is freed after its backward, which
  keeps one microbatch's activations alive at a time without it.
* The step does not compress gradients, as the reference's does not
  (:mod:`repro_torch.train.grad_compress` is a library).
* With M > 1 the MoE aux loss is reported as 0, as in the reference (each
  microbatch's aux still enters its loss and gradients).
* Under a mesh (:func:`repro_torch.models.sharding.active_rules`, the model's
  parameters, the moments and the batch DTensors, see
  :mod:`repro_torch.launch.mesh`) each microbatch's gradients are pinned to
  the parameter sharding as the reference pins them (``shard_tree``):
  ``Partial -> Shard`` is the reduce-scatter into the fsdp shard.  The loss
  and metrics are read through ``full_tensor()``: a DTensor scalar's local
  value can be one rank's partial sum.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import obs
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (from_local_even, keep_shards,
                                         local_offset, shard, shard_tree,
                                         to_local_at)
from repro_torch.models.transformer import Transformer, init_params, param_specs
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

TrainState = Dict[str, Any]   # {"params": Transformer, "opt": ..., "step": int32}
Batch = Mapping[str, torch.Tensor]


def train_state_init(generator: torch.Generator, cfg: ModelConfig,
                     opt: AdamWConfig, device="cuda") -> TrainState:
    """A fresh model (:func:`init_params` from ``generator``, which lives on
    ``device``) with grad turned on, zero AdamW state and step 0."""
    model = init_params(cfg, generator, device).requires_grad_(True)
    return {"params": model,
            "opt": adamw_init(dict(model.named_parameters()), opt),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def loss_fn(model: Transformer, batch: Batch, cfg: ModelConfig,
            aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM cross entropy in f32 over ``logits[:, -Tl:]`` (a vision
    prefix is cut off), masked to ``labels >= 0`` and averaged over the
    unmasked tokens, plus ``aux_weight`` times the MoE load-balance loss.
    batch: tokens, labels (+ frames / patches)."""
    extras = {k: batch[k] for k in ("frames", "patches") if k in batch}
    logits, aux = model(batch["tokens"], **extras)
    labels = batch["labels"]
    Tl = labels.shape[1]
    # A masked label (< 0) gathers slot 0; the mask zeroes its term.
    nll = _nll(logits[:, -Tl:].float(), labels.clamp(min=0).long())
    mask = (labels >= 0).float()
    ntok = torch.clamp(mask.sum(), min=1.0)
    ce = torch.sum(nll * mask) / ntok
    loss = ce + aux_weight * aux
    return _whole(loss), {"ce": _whole(ce), "moe_aux": _whole(aux)}


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logsumexp(logits) - logits[label], (B, T) from (B, T, V) f32 logits.

    DTensor logits sharded over the vocab are never gathered: each rank
    takes the max, the exp-sum and its label's logit over its own vocab
    shard, and only those (B, T) values are reduced over the vocab's mesh
    dims (the vocab-parallel cross entropy).  The max is a constant of the
    gradient (logsumexp's does not depend on it)."""
    vocab = ([m for m, p in enumerate(logits.placements) if p == Shard(2)]
             if isinstance(logits, DTensor) else [])
    if not vocab:
        logits = shard(logits, "batch", None, None)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1) - gold
    mesh = logits.device_mesh
    pl = keep_shards(logits, (0, 2))
    bpl = tuple(Replicate() if p == Shard(2) else p for p in pl)
    logits = logits.redistribute(mesh, pl)
    off = local_offset(logits, 2)
    ll = logits.to_local()
    tgt = to_local_at(labels, mesh, bpl) - off
    inside = (tgt >= 0) & (tgt < ll.shape[-1])
    m = ll.detach().amax(dim=-1)
    for d in vocab:
        m = funcol.all_reduce(m, "max", mesh.get_group(d))
    s = torch.exp(ll - m[..., None]).sum(dim=-1)
    gold = torch.gather(ll, -1, tgt.clamp(0, ll.shape[-1] - 1)[..., None])[..., 0]
    parts = torch.stack([s, gold * inside], dim=-1)
    ppl = tuple(Partial() if p == Shard(2) else p for p in pl)
    parts = from_local_even(parts, mesh, ppl).redistribute(mesh, bpl).to_local()
    nll = m + torch.log(parts[..., 0]) - parts[..., 1]
    return from_local_even(nll, mesh, bpl)


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor as the plain tensor it stands for (differentiably), the
    same on every rank; a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(cfg: ModelConfig, opt: AdamWConfig,
                    num_microbatches: int = 1, aux_weight: float = 0.01):
    """Build the train step for this arch."""
    M = num_microbatches
    pspecs = param_specs(cfg)

    def grad_fn(model: Transformer, batch: Batch, acc=None):
        """The loss, its parts and the gradients, pinned to the parameters'
        sharding; with ``acc``, each gradient over M is added into it (f32)
        instead."""
        params = dict(model.named_parameters())
        with obs.span(obs.FORWARD):
            loss, aux = loss_fn(model, batch, cfg, aux_weight)
        with obs.span(obs.BACKWARD):
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            if acc is None:
                grads = shard_tree(grads, pspecs)
            else:
                for n, gi in grads.items():
                    acc[n].add_(shard(gi.float() / M, *pspecs[n]))
        return loss.detach(), {k: a.detach() for k, a in aux.items()}, grads

    def train_step(state: TrainState, batch: Batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state["params"]
        if M == 1:
            loss, aux, grads = grad_fn(model, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % M:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"{M} microbatches")
            mb = B // M
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in model.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            ce = torch.zeros_like(loss)
            for i in range(M):
                part = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
                lval, a, _ = grad_fn(model, part, grads)
                loss = loss + lval / M
                ce = ce + a["ce"] / M
            aux = {"ce": ce, "moe_aux": torch.zeros_like(loss)}

        params = dict(model.named_parameters())
        with obs.span(obs.OPTIMIZER):
            _, newopt, om = adamw_update(grads, state["opt"], params, opt)
        step = state["step"] + 1
        metrics = {"loss": loss, **aux, **om, "step": step}
        return {"params": model, "opt": newopt, "step": step}, metrics

    return train_step

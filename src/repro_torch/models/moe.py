"""Mixture-of-Experts FFN: top-k router + capacity-bounded sorted dispatch.

Ported from ``repro.models.moe``, its ``sort_scatter`` path only.  The
reference's ``a2a`` dispatch (a ``shard_map`` with two all-to-alls over the
mesh's expert axis) runs only under a mesh context and falls back to
``sort_scatter`` without one; the port has no mesh until the distribution
slice, so every config, ``moe_impl="a2a"`` (granite) included, takes
``sort_scatter``.

Routing is the reference's: f32 router logits, top-k, the k weights
renormalized by a softmax over their logits, and each (token, choice) slot
placed at its position among the slots of its expert in token order (a
stable sort); slots past the capacity C are dropped.  The data path differs
in form, not in value:

* dispatch scatters each slot's token into ``E*C + 1`` rows, the last a
  "trash" row that takes every dropped slot and is sliced off, as the
  reference's ``mode="drop"`` scatter discards them (no boolean mask, so no
  data-dependent shapes and no host sync);
* the combine scatters each slab row's expert output back to the slot that
  filled it (rows no slot filled go to a trash slot; dropped slots stay 0)
  and sums each token's k slots, (S, k, D) over k, where the reference
  scatter-adds them into the tokens' rows.

Every scatter writes distinct rows or a discarded trash row, and its
gradient is a gather; the sum over k adds in a fixed order, and its
gradient is a broadcast.  Nothing accumulates into a shared row, forward
or backward, so the result and its gradients are the same bits from call
to call on the card, where a scatter-add would add in whatever order its
atomics land (and a gather's backward, a sorted accumulation, would cost
more than the experts' products).

The expert FFN is three batched products over (E, C, D), as in the
reference, which computes them outside any Pallas kernel; so this module
has no CUDA kernel of its own.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, Shapes, dense_


def moe_params(cfg: ModelConfig) -> Shapes:
    """``router`` (D, E) in f32; ``wi`` (and ``wg`` for the gated FFNs)
    (E, D, F) and ``wo`` (E, F, D) in ``cfg.dtype``."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    p = {"router": ((D, E), torch.float32), "wi": ((E, D, Fd), cfg.dtype),
         "wo": ((E, Fd, D), cfg.dtype)}
    if cfg.ffn in ("swiglu", "geglu"):
        p["wg"] = ((E, D, Fd), cfg.dtype)
    return p


def moe_init_(p: Params, cfg: ModelConfig, generator: torch.Generator) -> None:
    """The reference's fan-ins: D for the router, ``wi`` and ``wg``; F for
    ``wo``."""
    for name, fan_in in (("router", cfg.d_model), ("wi", cfg.d_model),
                         ("wg", cfg.d_model), ("wo", cfg.d_ff)):
        if name in p:
            dense_(p[name], fan_in, generator)


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(cfg.moe_capacity * cfg.moe_topk * n_tokens / cfg.moe_experts)
    return max(8, -(-c // 8) * 8)  # round up to a lane-friendly multiple


class Routing(NamedTuple):
    """``_route``'s outputs.  The first six are the reference's, over the
    S*k slots in expert-sorted order; ``order`` maps that order to the slot
    index ``s*k + j`` (token s, its j-th choice), and ``weights`` are the
    renormalized top-k weights in slot order."""

    dest: torch.Tensor      # (S*k,) row of the (E*C,) slab; E*C = dropped
    tok: torch.Tensor       # (S*k,) source token
    wslot: torch.Tensor     # (S*k,) f32 combine weight, 0 where dropped
    keep: torch.Tensor      # (S*k,) bool
    counts: torch.Tensor    # (E,) slots routed to each expert, drops included
    probs: torch.Tensor     # (S, E) f32 router softmax
    order: torch.Tensor     # (S*k,) slot index of each sorted position
    weights: torch.Tensor   # (S, k) f32


def _route(xf: torch.Tensor, router: torch.Tensor, E: int, k: int,
           C: int) -> Routing:
    """Top-k routing with capacity positions via stable sort."""
    S = xf.shape[0]
    logits = torch.einsum("sd,de->se", xf.float(), router.float())
    probs = torch.softmax(logits, dim=-1)                       # (S,E)
    topv, topi = torch.topk(logits, k, dim=-1)                  # (S,k)
    weights = torch.softmax(topv, dim=-1)                       # renormalized

    fe = topi.reshape(-1)                                       # (S*k,)
    fe_sorted, order = torch.sort(fe, stable=True)
    counts = torch.bincount(fe, minlength=E)
    starts = torch.cumsum(counts, 0) - counts                   # (E,)
    pos = torch.arange(S * k, device=xf.device) - starts[fe_sorted]
    keep = pos < C
    dest = torch.where(keep, fe_sorted * C + pos, E * C)
    tok = order // k                                            # source token
    wslot = weights.reshape(-1)[order] * keep
    return Routing(dest, tok, wslot, keep, counts, probs, order, weights)


def _expert_ffn(slab: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    """(E, C, D) slab -> (E, C, D) through each expert's FFN."""
    h = torch.einsum("ecd,edf->ecf", slab, p["wi"])
    if cfg.ffn in ("swiglu", "geglu"):
        g = torch.einsum("ecd,edf->ecf", slab, p["wg"])
        act = (F.silu(g.float()) if cfg.ffn == "swiglu"
               else F.gelu(g.float(), approximate="tanh"))
        h = act.to(h.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return torch.einsum("ecf,efd->ecd", h, p["wo"])


def _aux_loss(counts: torch.Tensor, probs: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balance loss from local routing statistics."""
    S_k = torch.clamp(counts.sum(), min=1)
    me = probs.mean(dim=0)
    ce = counts.float() / S_k.float()
    return E * torch.sum(me * ce)


def _moe_local(xf: torch.Tensor, p: Params, cfg: ModelConfig, C: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sort-scatter data path on a flat (S, D) token array."""
    S, D = xf.shape
    E, k = cfg.moe_experts, cfg.moe_topk
    r = _route(xf, p["router"], E, k, C)
    # Each slot's slab row and weight, in slot order (s*k + j), and the slot
    # that fills each slab row (S*k, a trash slot, where none does).
    n = S * k
    dest = torch.empty_like(r.dest).index_put_((r.order,), r.dest)
    keep = torch.empty_like(r.keep).index_put_((r.order,), r.keep)
    w = r.weights.reshape(-1) * keep
    filler = torch.full((E * C + 1,), n, dtype=dest.dtype, device=dest.device)
    filler = filler.index_put_((dest,), torch.arange(n, device=dest.device))[:E * C]
    # Dispatch: slot s*k + j carries token s; dropped slots land in the
    # trash row E*C.
    slots = xf[:, None, :].expand(S, k, D).reshape(n, D)
    slab = xf.new_zeros((E * C + 1, D)).index_put((dest,), slots)
    ye = _expert_ffn(slab[:E * C].reshape(E, C, D), p, cfg).reshape(E * C, D)
    # Combine: each row back to its slot, then each token's k slots summed.
    out = ye.new_zeros((n + 1, D)).index_put((filler,), ye)[:n]
    y = (out * w.to(xf.dtype)[:, None]).reshape(S, k, D).sum(dim=1)
    return y, _aux_loss(r.counts, r.probs, E)


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,D) -> (y (B,T,D), aux_loss f32 scalar).  ``sort_scatter`` on
    the call's B*T tokens, whatever ``cfg.moe_impl`` says (see the module
    docstring)."""
    B, T, D = x.shape
    y, aux = _moe_local(x.reshape(B * T, D), p, cfg, capacity(cfg, B * T))
    return y.reshape(B, T, D), aux

"""Mixture-of-Experts FFN: top-k router + capacity-bounded sorted dispatch.

Ported from ``repro.models.moe``.  Two dispatch implementations share the
same routing math:

* ``sort_scatter``: the call's tokens are sorted by expert into an
  (E*C, D) slab, every expert runs on it, and the outputs are combined back.
  Under a mesh (:func:`repro_torch.models.sharding.active_rules`) each rank
  routes its data shard's tokens into the global slot order and runs its
  own experts on its share of their capacity rows (:func:`_moe_sharded`),
  the work the reference's GSPMD gives each device when it partitions the
  same scatters; DTensor has no sharding rule for them, so it is done here
  explicitly.
* ``a2a`` (``cfg.moe_impl="a2a"``, granite) under a mesh whose expert axis
  divides the expert count: GShard-style expert parallelism, the
  reference's ``shard_map`` as explicit per-rank code.  Each rank routes its
  own shard of the tokens into an (E, C_local, D) slab, an all-to-all over
  the expert axis delivers each expert's rows to the rank that holds it,
  the local experts run, and a second all-to-all returns their outputs for
  the local combine: two all-to-alls per layer forward (``A2A_CALLS``
  counts them).  The aux loss is the mean of the ranks' local losses, as
  the reference's ``pmean``.  Without a mesh, or where the reference gives
  way (no expert axis, or one that does not divide E), it takes
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

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed._functional_collectives import all_to_all_single_autograd
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import obs
from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, Shapes, dense_
from repro_torch.models.sharding import P

# All-to-alls launched by the a2a dispatch, forward only (2 per layer call).
A2A_CALLS = 0


def moe_params(cfg: ModelConfig) -> Shapes:
    """``router`` (D, E) in f32; ``wi`` (and ``wg`` for the gated FFNs)
    (E, D, F) and ``wo`` (E, F, D) in ``cfg.dtype``."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    p = {"router": ((D, E), torch.float32), "wi": ((E, D, Fd), cfg.dtype),
         "wo": ((E, Fd, D), cfg.dtype)}
    if cfg.ffn in ("swiglu", "geglu"):
        p["wg"] = ((E, D, Fd), cfg.dtype)
    return p


def moe_spec(cfg: ModelConfig) -> Dict[str, P]:
    p = {"router": P(None, None), "wo": P("model", None, "fsdp"),
         "wi": P("model", "fsdp", None)}
    if cfg.ffn in ("swiglu", "geglu"):
        p["wg"] = P("model", "fsdp", None)
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
           C: int, before: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
           ) -> Routing:
    """Top-k routing with capacity positions via stable sort.  ``before``,
    where given, maps the (E,) counts of these tokens' slots to the slots
    of each expert that tokens before them take (a data shard's place in
    the global order); positions start there."""
    S = xf.shape[0]
    logits = torch.einsum("sd,de->se", xf.float(), router.float())
    probs = torch.softmax(logits, dim=-1)                       # (S,E)
    topv, topi = torch.topk(logits, k, dim=-1)                  # (S,k)
    weights = torch.softmax(topv, dim=-1)                       # renormalized

    fe = topi.reshape(-1)                                       # (S*k,)
    fe_sorted, order = torch.sort(fe, stable=True)
    if fe.is_meta:       # the dry run: bincount's size depends on the data
        counts = torch.zeros(E, dtype=fe.dtype, device=fe.device).scatter_add_(
            0, fe, torch.ones_like(fe))
    else:
        counts = torch.bincount(fe, minlength=E)
    starts = torch.cumsum(counts, 0) - counts                   # (E,)
    if before is not None:
        starts = starts - before(counts)
    pos = torch.arange(S * k, device=xf.device) - starts[fe_sorted]
    keep = pos < C
    dest = torch.where(keep, fe_sorted * C + pos, E * C)
    tok = order // k                                            # source token
    wslot = weights.reshape(-1)[order] * keep
    return Routing(dest, tok, wslot, keep, counts, probs, order, weights)


def _expert_ffn(slab: torch.Tensor, p: Params, cfg: ModelConfig, up=None,
                down=None) -> torch.Tensor:
    """(E, C, D) slab -> (E, C, D) through each expert's FFN.  ``up(slab,
    w)`` and ``down(h, w)``, where given, compute the products with the
    (E, D, F) and (E, F, D) weights."""
    up = up or (lambda s, w: torch.einsum("ecd,edf->ecf", s, w))
    down = down or (lambda h, w: torch.einsum("ecf,efd->ecd", h, w))
    h = up(slab, p["wi"])
    if cfg.ffn in ("swiglu", "geglu"):
        g = up(slab, p["wg"])
        act = (F.silu(g.float()) if cfg.ffn == "swiglu"
               else F.gelu(g.float(), approximate="tanh"))
        h = act.to(h.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return down(h, p["wo"])


def _aux_loss(counts: torch.Tensor, probs: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balance loss from local routing statistics."""
    S_k = torch.clamp(counts.sum(), min=1)
    me = probs.mean(dim=0)
    ce = counts.float() / S_k.float()
    return E * torch.sum(me * ce)


def _dispatch(xf: torch.Tensor, r: Routing, E: int, C: int, e0: int = 0,
              El: Optional[int] = None, Cp: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(slab (El, Cp, D), the slot that fills each slab row, each slot's
    combine weight) of the flat (S, D) tokens routed by ``r``: the rows of
    experts ``e0 .. e0+El-1`` (all E by default), ``Cp >= C`` rows each
    (C by default); the slots of other experts are left out as dropped
    ones are."""
    S, D = xf.shape
    n = r.dest.shape[0]
    k = n // S
    El = E if El is None else El
    Cp = C if Cp is None else Cp
    e = r.dest // C
    mine = r.keep & (e >= e0) & (e < e0 + El)
    ldest = torch.where(mine, (e - e0) * Cp + r.dest - e * C, El * Cp)
    # Each slot's slab row and weight, in slot order (s*k + j), and the slot
    # that fills each slab row (n, a trash slot, where none does).
    dest = torch.empty_like(ldest).index_put_((r.order,), ldest)
    keep = torch.empty_like(mine).index_put_((r.order,), mine)
    w = r.weights.reshape(-1) * keep
    filler = torch.full((El * Cp + 1,), n, dtype=dest.dtype, device=dest.device)
    filler = filler.index_put_((dest,), torch.arange(n, device=dest.device))[:El * Cp]
    # Slot s*k + j carries token s; left-out slots land in the trash row.
    slots = xf[:, None, :].expand(S, k, D).reshape(n, D)
    slab = xf.new_zeros((El * Cp + 1, D)).index_put((dest,), slots)
    return slab[:El * Cp].reshape(El, Cp, D), filler, w


def _combine(ye: torch.Tensor, filler: torch.Tensor, w: torch.Tensor,
             S: int) -> torch.Tensor:
    """Each (E*C, D) output row back to its slot, then each token's k slots
    summed in order: (S, D)."""
    n, D = w.shape[0], ye.shape[-1]
    out = ye.new_zeros((n + 1, D)).index_put((filler,), ye)[:n]
    return (out * w.to(ye.dtype)[:, None]).reshape(S, n // S, D).sum(dim=1)


def _moe_local(xf: torch.Tensor, p: Params, cfg: ModelConfig, C: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sort-scatter data path on a flat (S, D) token array."""
    S, D = xf.shape
    E = cfg.moe_experts

    def dispatch(xf, router):
        r = _route(xf, router, E, cfg.moe_topk, C)
        slab, filler, w = _dispatch(xf, r, E, C)
        return slab, w, r.probs, filler, r.counts

    slab, w, probs, filler, counts = obs.region(obs.MOE_DISPATCH, dispatch, xf, p["router"])
    ye = _expert_ffn(slab, p, cfg).reshape(E * C, D)
    y = obs.region(obs.MOE_DISPATCH, _combine, ye, filler, w, S)
    return y, _aux_loss(counts, probs, E)


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,D) -> (y (B,T,D), aux_loss f32 scalar).  ``a2a`` under a mesh
    that allows it, else ``sort_scatter`` (see the module docstring)."""
    ctx = sh.current_context()
    if cfg.moe_impl == "a2a" and ctx is not None:
        out = _moe_forward_a2a(p, x, cfg, *ctx)
        if out is not None:
            return out
    if isinstance(x, DTensor):
        return _moe_sharded(p, x, cfg)
    B, T, D = x.shape
    y, aux = _moe_local(x.reshape(B * T, D), p, cfg, capacity(cfg, B * T))
    return y.reshape(B, T, D), aux


class _ScaleGrad(torch.autograd.Function):
    """The identity, with its gradient scaled by ``c``."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def _moe_sharded(p: Params, x: DTensor, cfg: ModelConfig
                 ) -> Tuple[DTensor, DTensor]:
    """``sort_scatter`` under a mesh, on each rank's shard; the unsharded
    function (global capacity, global slot order, drops past C).

    * Each data shard of the tokens (the ranks that hold the same batch
      rows) routes its own tokens.  Its slots of expert e start after the
      slots that the shards before it in the batch take (an all-gather of
      the (E,) counts): with the batch split contiguously in rank order,
      that is the global stable-sort order.
    * The expert dims (mesh dims that shard ``wi``'s experts) each hold
      ``El`` experts; every other mesh dim (the row dims) splits each
      expert's capacity rows, padded to ``Cp``, so each rank runs its
      experts' FFN on Cp/G rows, as the reference's partitioned scatter
      does.  A shard's slots reach the rows' owners as a reduce-scatter of
      its (El, Cp, D) slab over the token dims, whose rows only it fills,
      and come back as an all-gather.
    * The weights are gathered over the row dims as fsdp gathers on use;
      a decode step (one position, no grad) instead runs each product on
      the weights' stored shards and moves its few rows
      (:func:`_experts_on_features`).
    * Each rank combines its experts' slots into its tokens: a partial sum
      over the expert dims, reduced to the batch-sharded residual layout as
      a tensor-parallel FFN output is.
    * The aux loss takes the global counts and the global mean of
      ``probs``.  Its gradient reaches x and the router on every rank of
      the expert dims, which (as partial sums) add up: each takes 1/n of
      it."""
    mesh, nd = x.device_mesh, x.device_mesh.ndim
    B, T, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_topk
    C = capacity(cfg, B * T)
    xpl = sh.keep_shards(x, (0,))
    tok = [m for m in range(nd) if isinstance(xpl[m], Shard)]
    ex = [m for m, pl in enumerate(p["wi"].placements)
          if pl == Shard(0) and m not in tok]
    n_ex = 1
    for m in ex:
        n_ex *= mesh.size(m)
    one = T == 1 and not torch.is_grad_enabled()
    El, G = E // n_ex, 1 if one else mesh.size() // n_ex
    Cp = -(-C // G) * G
    part = tuple(Partial() if m in ex else pl for m, pl in enumerate(xpl))
    rep = (Replicate(),) * nd
    xd = x.redistribute(mesh, xpl)
    xl = xd.to_local(grad_placements=part)
    Bl = xl.shape[0]
    g = sh.local_offset(xd, 0) // Bl
    router = sh.to_local_at(p["router"], mesh, rep, tuple(
        Partial() if m in tok or m in ex else Replicate() for m in range(nd)))
    e0 = sh.local_offset(p["wi"], 0)
    cpl = tuple(Shard(0) if m in tok else Replicate() for m in range(nd))
    totals = []

    def before(counts: torch.Tensor) -> torch.Tensor:
        every = sh.from_local_even(counts[None], mesh, cpl).full_tensor()
        totals.append(every.sum(0))
        return every[:g].sum(0)

    xf = xl.reshape(Bl * T, D)
    r = _route(xf, router, E, k, C, before)
    slab, filler, w = _dispatch(xf, r, E, C, e0, El, Cp)
    run = _experts_on_features if one else _experts_on_rows
    ye = run(slab, p, cfg, mesh, ex, tok)
    y = _combine(ye.reshape(El * Cp, D), filler, w, Bl * T)
    y = sh.from_local_even(y.reshape(Bl, T, D), mesh, part).redistribute(mesh, xpl)

    probs = r.probs if n_ex == 1 else _ScaleGrad.apply(r.probs, 1.0 / n_ex)
    me = sh.from_local_even(probs.sum(0)[None], mesh, tuple(
        Partial() if m in tok else Replicate() for m in range(nd)))
    me = me.redistribute(mesh, rep).to_local()[0] / (B * T)
    counts = totals[0]
    ce = counts.float() / torch.clamp(counts.sum(), min=1).float()
    aux = E * torch.sum(me * ce)
    return y, DTensor.from_local(aux, mesh, rep)


def _experts_on_rows(slab: torch.Tensor, p: Params, cfg: ModelConfig, mesh,
                     ex, tok) -> torch.Tensor:
    """This rank's experts' FFN on its group's (El, Cp, D) slab, each
    expert's rows split over the mesh dims other than the expert dims
    ``ex``: the slab reduce-scattered over the token dims ``tok`` (each
    group fills only its own slots' rows), the weights gathered, the
    outputs all-gathered back.  Returns the whole (El, Cp, D) output, its
    gradient a partial sum over the token dims."""
    nd = mesh.ndim
    src = tuple(Shard(0) if m in ex else Partial() if m in tok else Replicate()
                for m in range(nd))
    rows = tuple(Shard(0) if m in ex else Shard(1) for m in range(nd))
    whole = tuple(Shard(0) if m in ex else Replicate() for m in range(nd))
    slab = sh.from_local_even(slab, mesh, src).redistribute(mesh, rows).to_local()
    pl = {n: sh.to_local_at(p[n], mesh, whole, sh.partial_where(rows, whole))
          for n in ("wi", "wg", "wo") if n in p}
    ye = sh.from_local_even(_expert_ffn(slab, pl, cfg), mesh, rows)
    return ye.redistribute(mesh, whole).to_local(grad_placements=tuple(
        Partial() if m in tok else pl_ for m, pl_ in enumerate(whole)))


def _experts_on_features(slab: torch.Tensor, p: Params, cfg: ModelConfig, mesh,
                         ex, tok) -> torch.Tensor:
    """The same for a one-position step without grad (decode), where the
    slab is a few rows and the weights are the bytes to spare: the slab is
    summed whole over the token dims, and each product runs on the
    weights' stored shards of D (fsdp), its partial sums reduced (up) or
    its D shards gathered (down)."""
    nd = mesh.ndim
    src = tuple(Shard(0) if m in ex else Partial() if m in tok else Replicate()
                for m in range(nd))
    whole = tuple(Shard(0) if m in ex else Replicate() for m in range(nd))
    slab = sh.from_local_even(slab, mesh, src).redistribute(mesh, whole).to_local()
    wi = p["wi"]
    d0, dl = sh.local_offset(wi, 1), wi.to_local().shape[1]
    ppl = tuple(Partial() if pl == Shard(1) and m not in ex else pl
                for m, pl in enumerate(wi.placements))

    def up(s, w):
        h = torch.einsum("ecd,edf->ecf", s[..., d0:d0 + dl], w)
        return sh.from_local_even(h, mesh, ppl).redistribute(mesh, whole).to_local()

    def down(h, w):
        return sh.from_local_even(torch.einsum("ecf,efd->ecd", h, w), mesh,
                                  p["wo"].placements).redistribute(mesh, whole).to_local()

    return _expert_ffn(slab, {n: p[n].to_local() for n in ("wi", "wg", "wo") if n in p},
                       cfg, up, down)


def _rule_axes(rules, key) -> Tuple[str, ...]:
    v = rules.get(key)
    if v is None:
        return ()
    return v if isinstance(v, tuple) else (v,)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Chunk g of ``t`` along dim 0 to rank g of ``group``; chunk g of the
    result from rank g.  Differentiable (its gradient is the reverse
    all-to-all)."""
    global A2A_CALLS
    A2A_CALLS += 1
    return all_to_all_single_autograd(t.contiguous(), None, None, group)


def _moe_forward_a2a(p: Params, x: DTensor, cfg: ModelConfig, rules, mesh
                     ) -> Optional[Tuple[DTensor, DTensor]]:
    """GShard-style expert parallelism over the mesh's expert axis.

    Returns None (the caller falls back to sort_scatter) when the expert
    count does not divide the expert axis or no expert axis is mapped."""
    B, T, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_topk
    sizes = sh.axis_sizes(mesh)
    ex = [a for a in _rule_axes(rules, "expert")
          if a in sizes and E % sizes[a] == 0 and sizes[a] > 1]
    if not ex:
        return None
    ex_ax = ex[0]
    G = sizes[ex_ax]

    # Token sharding inside the MoE region: batch over the data axes AND over
    # the expert axis itself (else every rank of an expert-axis row routes
    # the same tokens).  Batch first; if B does not divide, shard the
    # sequence over the expert axis instead.
    dp, cur = [], 1
    for a in (*_rule_axes(rules, "batch"), ex_ax):
        if a in dp or a not in sizes:
            continue
        if B % (cur * sizes[a]) == 0:
            dp.append(a)
            cur *= sizes[a]
    seq_ax = ex_ax if ex_ax not in dp and T % G == 0 else None
    S_loc = (B // cur) * (T // (G if seq_ax else 1))
    C = capacity(cfg, S_loc)
    names = mesh.mesh_dim_names
    x_pl = tuple(Shard(0) if a in dp else Shard(1) if a == seq_ax
                 else Replicate() for a in names)
    w_pl = tuple(Shard(0) if a == ex_ax else Replicate() for a in names)
    rep = (Replicate(),) * len(names)

    xl = x.redistribute(mesh, x_pl).to_local()
    # A weight's local gradient sums over this rank's tokens only: Partial
    # over the mesh dims that split the tokens.
    router = p["router"].redistribute(mesh, rep).to_local(
        grad_placements=sh.partial_where(x_pl, rep))
    pl = {n: p[n].redistribute(mesh, w_pl).to_local(
        grad_placements=sh.partial_where(x_pl, w_pl))
        for n in ("wi", "wg", "wo") if n in p}
    Bl, Tl, _ = xl.shape
    xf = xl.reshape(Bl * Tl, D)
    r = _route(xf, router, E, k, C)
    slab, filler, w = _dispatch(xf, r, E, C)
    group = sh.mesh_group(mesh, ex_ax)
    El = E // G
    # To the experts' owners: (E, C, D) -> (E/G, G*C, D), source rank major.
    recv = _all_to_all(slab, group)
    ye = _expert_ffn(recv.reshape(G, El, C, D).transpose(0, 1)
                     .reshape(El, G * C, D), pl, cfg)
    # Back to the tokens' owners: (E/G, G*C, D) -> (E, C, D).
    ye = _all_to_all(ye.reshape(El, G, C, D).transpose(0, 1), group)
    y = _combine(ye.reshape(E * C, D), filler, w, Bl * Tl).reshape(Bl, Tl, D)
    aux = _aux_loss(r.counts, r.probs, E).reshape(1)
    world = mesh.size()
    aux = DTensor.from_local(aux, mesh, (Shard(0),) * len(names),
                             shape=(world,), stride=(1,)).mean()
    return (DTensor.from_local(y, mesh, x_pl, shape=x.shape,
                               stride=x.stride()), aux)

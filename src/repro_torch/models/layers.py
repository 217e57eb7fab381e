"""Shared neural building blocks: norms, RoPE, GQA attention, FFN, embedding.

Ported from ``repro.models.layers``.  Each function takes its parameters as
a mapping of tensors (a plain dict or an ``nn.ParameterDict``) in the
reference's layouts: ``wq (D,H,hd)``, ``wk``/``wv (D,K,hd)``,
``wo (H,hd,D)``, ``wi``/``wg (D,F)``, FFN ``wo (F,D)``, ``table (Vp,D)``,
``head (D,Vp)``.  The f32 upcasts of the reference are kept exactly: norms
(computed in f32 by :func:`ops.norm`, one CUDA kernel on the card), RoPE
angles, the FFN gate's activation and attention scores.

``*_params(cfg)`` give each parameter group's ``{name: (shape, dtype)}`` and
``*_init_`` fill such a group in place with the reference's initialization
(``repro.models.layers.*_init``), drawn from a ``torch.Generator``;
``*_spec(cfg)`` give the group's logical sharding specs (the reference's),
which :mod:`repro_torch.models.sharding` binds to a mesh.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import P

Params = Mapping[str, torch.Tensor]
Shapes = Dict[str, Tuple[tuple, torch.dtype]]


def dense_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Fill ``w`` with N(0,1)/sqrt(fan_in) drawn in f32 and cast to its dtype
    (the reference's ``_dense``)."""
    w.copy_(torch.randn(w.shape, generator=generator, dtype=torch.float32,
                        device=w.device) * fan_in ** -0.5)


def norm_params(cfg: ModelConfig) -> Shapes:
    names = ("scale", "bias") if cfg.norm == "layernorm" else ("scale",)
    return {n: ((cfg.d_model,), torch.float32) for n in names}


def norm_spec(cfg: ModelConfig) -> Dict[str, P]:
    p = {"scale": P(None)}
    if cfg.norm == "layernorm":
        p["bias"] = P(None)
    return p


def norm_init_(p: Params) -> None:
    p["scale"].fill_(1.0)
    if "bias" in p:
        p["bias"].zero_()


def attn_params(cfg: ModelConfig) -> Shapes:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": ((D, H, hd), cfg.dtype), "wk": ((D, K, hd), cfg.dtype),
         "wv": ((D, K, hd), cfg.dtype), "wo": ((H, hd, D), cfg.dtype)}
    if cfg.qkv_bias:
        p.update(bq=((H, hd), torch.float32), bk=((K, hd), torch.float32),
                 bv=((K, hd), torch.float32))
    if cfg.qk_norm:
        p.update(q_norm=((hd,), torch.float32), k_norm=((hd,), torch.float32))
    return p


def attn_spec(cfg: ModelConfig) -> Dict[str, P]:
    # Head dims shard over "model" only when divisible; resolve_spec drops
    # the axis otherwise.
    p = {"wq": P("fsdp", "model", None), "wk": P("fsdp", "model_kv", None),
         "wv": P("fsdp", "model_kv", None), "wo": P("model", None, "fsdp")}
    if cfg.qkv_bias:
        p.update(bq=P("model", None), bk=P("model_kv", None),
                 bv=P("model_kv", None))
    if cfg.qk_norm:
        p.update(q_norm=P(None), k_norm=P(None))
    return p


def attn_init_(p: Params, cfg: ModelConfig, generator: torch.Generator) -> None:
    D = cfg.d_model
    for name, fan_in in (("wq", D), ("wk", D), ("wv", D),
                         ("wo", cfg.n_heads * cfg.head_dim)):
        dense_(p[name], fan_in, generator)
    for name in ("bq", "bk", "bv"):
        if name in p:
            p[name].zero_()
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name].fill_(1.0)


def ffn_params(cfg: ModelConfig) -> Shapes:
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"wi": ((D, Fd), cfg.dtype), "wo": ((Fd, D), cfg.dtype)}
    if cfg.ffn in ("swiglu", "geglu"):
        p["wg"] = ((D, Fd), cfg.dtype)
    return p


def ffn_spec(cfg: ModelConfig) -> Dict[str, P]:
    p = {"wo": P("model", "fsdp"), "wi": P("fsdp", "model")}
    if cfg.ffn in ("swiglu", "geglu"):
        p["wg"] = P("fsdp", "model")
    return p


def embed_spec(cfg: ModelConfig) -> Dict[str, P]:
    return {"table": P("vocab", None), "head": P("fsdp", "vocab")}


def ffn_init_(p: Params, cfg: ModelConfig, generator: torch.Generator) -> None:
    for name, fan_in in (("wi", cfg.d_model), ("wg", cfg.d_model),
                         ("wo", cfg.d_ff)):
        if name in p:
            dense_(p[name], fan_in, generator)


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time.  u: (B,T,C); w: (W,C); b: (C,).

    Summed tap by tap in u's dtype, as the reference's mixers do.  A DTensor
    u runs on each rank's batch and channel shard (DTensor cannot plan the
    padding's redistribution, torch 2.11)."""
    if isinstance(u, DTensor):
        mesh = u.device_mesh
        upl = sh.keep_shards(u, (0, 2))
        wpl = tuple(Shard(1) if p == Shard(2) else Replicate() for p in upl)
        bpl = tuple(Shard(0) if p == Shard(2) else Replicate() for p in upl)
        out = causal_conv(sh.to_local_at(u, mesh, upl),
                          sh.to_local_at(w, mesh, wpl, sh.partial_where(upl, wpl)),
                          sh.to_local_at(b, mesh, bpl, sh.partial_where(upl, bpl)))
        return sh.from_local_even(out, mesh, upl)
    W, T = w.shape[0], u.shape[1]
    upad = F.pad(u, (0, 0, W - 1, 0))
    return sum(upad[:, k:k + T] * w[k] for k in range(W)) + b.to(u.dtype)


def conv_tail(u: torch.Tensor, W: int) -> torch.Tensor:
    """The last W-1 steps of u (B,T,C), zero-padded in front when T < W-1:
    the conv window a decode step continues from.  A fresh tensor, so the
    cache does not keep u alive.  A DTensor u runs on each rank's batch and
    channel shard."""
    if isinstance(u, DTensor):
        mesh, pl = u.device_mesh, sh.keep_shards(u, (0, 2))
        return sh.from_local_even(conv_tail(sh.to_local_at(u, mesh, pl), W),
                                  mesh, pl)
    return F.pad(u[:, -(W - 1):], (0, 0, max(W - 1 - u.shape[1], 0), 0))


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    """``cfg.norm`` over the last dim of x (:func:`ops.norm`)."""
    return ops.norm(x, p["scale"], p["bias"] if cfg.norm == "layernorm" else None,
                    cfg.norm, eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B,T,H,D) with even D; positions: (T,) or (B,T)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        ang = positions[None, :, None].float() * freqs      # (1,T,half)
    else:
        ang = positions[..., None].float() * freqs          # (B,T,half)
    ang = ang[..., None, :]                                 # (.,T,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _qk_normalize(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of x (qk-norm, Jamba's dt/B/C norms)."""
    return ops.norm(x, scale, None, "rmsnorm", eps)


def attn_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
             positions: Optional[torch.Tensor],
             kv_from: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project to (q, k, v); applies bias, qk-norm, RoPE (none with
    ``cfg.use_rope`` off, as Jamba's attention has none)."""
    src = x if kv_from is None else kv_from
    q = _heads(x, p["wq"])
    k = _heads(src, p["wk"])
    v = _heads(src, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if cfg.qk_norm:
        q = _qk_normalize(q, p["q_norm"])
        k = _qk_normalize(k, p["k_norm"])
    if positions is not None and kv_from is None and cfg.use_rope:   # not cross-attn
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)``.  A DTensor x is projected on each
    rank's batch (and sequence) shards and the weight's head shards, the
    weight gathered over its other dims as fsdp gathers on use: DTensor's
    own plan may shard the flattened heads x head_dim output over more
    ranks than there are heads, which the split into heads cannot hold.
    Where the heads are not split over a mesh dim that holds x whole (KV
    heads that the model axis does not divide), the ranks of that dim each
    project a slice of head_dim and gather the slices: the same bytes as
    the heads' shards, not the whole product on every rank."""
    if not isinstance(x, DTensor):
        return torch.einsum("bsd,dhk->bshk", x, w)
    mesh = x.device_mesh
    xpl = sh.keep_shards(x, (0, 1))
    wpl = (w.placements if isinstance(w, DTensor)
           else (Replicate(),) * mesh.ndim)
    split, new = 1, []
    for m, (wp, xp) in enumerate(zip(wpl, xpl)):
        if isinstance(xp, Shard):
            wp = Replicate()
        elif wp != Shard(1):
            wp = Shard(2) if w.shape[2] % (split * mesh.size(m)) == 0 else Replicate()
            split *= mesh.size(m) if wp == Shard(2) else 1
        new.append(wp)
    wpl = tuple(new)
    opl = tuple(xp if isinstance(xp, Shard) else Shard(wp.dim + 1)
                if isinstance(wp, Shard) else Replicate()
                for xp, wp in zip(xpl, wpl))
    out = torch.einsum("bsd,dhk->bshk",
                       sh.to_local_at(x, mesh, xpl, sh.partial_where(opl, xpl)),
                       sh.to_local_at(w, mesh, wpl, sh.partial_where(opl, wpl)))
    out = sh.from_local_even(out, mesh, opl)
    whole = tuple(Replicate() if p == Shard(3) else p for p in opl)
    return out if whole == opl else out.redistribute(mesh, whole)


def attn_out(p: Params, o: torch.Tensor) -> torch.Tensor:
    """The output projection; under a mesh the heads' partial sums are
    reduced to the batch-sharded residual layout (no-op without one)."""
    return sh.shard(sh.product(o, p["wo"], 2), "batch", None, None)


def attn_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 causal: bool = True, window: int = 0,
                 positions: Optional[torch.Tensor] = None,
                 kv_from: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill / encoder)."""
    if positions is None and kv_from is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = attn_qkv(p, x, cfg, positions, kv_from)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    return attn_out(p, o)


def attn_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                cache_k: torch.Tensor, cache_v: torch.Tensor, index: int, *,
                window: int = 0, ring: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x: (B,1,D); cache: (B,S,K,hd); index: position.

    Writes the new K/V into ``cache_k``/``cache_v`` IN PLACE (the reference
    returns updated copies) and returns them.  ``ring=True`` writes at
    ``index % S`` (bounded local-window cache); positions stay absolute
    for RoPE.  A DTensor cache is written shard by shard: only the ranks
    whose sequence shard holds the slot write it.
    """
    B = x.shape[0]
    S = cache_k.shape[1]
    pos = torch.full((B, 1), index, dtype=torch.int64, device=x.device)
    q, k, v = attn_qkv(p, x, cfg, pos)
    slot = index % S if ring else min(index, S - 1)
    if isinstance(cache_k, DTensor):
        _write_slot(cache_k, k, slot)
        _write_slot(cache_v, v, slot)
    else:
        cache_k[:, slot] = k[:, 0]
        cache_v[:, slot] = v[:, 0]
    if ring:
        # Ring cache: all S slots are valid once full; mask handles warmup.
        o = ops.decode_attention(q, cache_k, cache_v, min(index + 1, S))
    else:
        o = ops.decode_attention(q, cache_k, cache_v, index + 1, window=window)
    return attn_out(p, o), cache_k, cache_v


def _write_slot(cache: DTensor, new: torch.Tensor, slot: int) -> None:
    """cache[:, slot] = new[:, 0] on the rank(s) whose sequence shard of the
    (B,S,K,hd) cache holds ``slot``; ``new`` (B,1,K,hd) is taken on the
    cache's batch and head shards."""
    mesh, cpl = cache.device_mesh, cache.placements
    npl = tuple(Replicate() if p == Shard(1) else p for p in cpl)
    new = sh.to_local_at(new, mesh, npl)      # every rank takes part
    local = cache.to_local()
    off = sh.local_offset(cache, 1)
    if off <= slot < off + local.shape[1]:
        local[:, slot - off] = new[:, 0]


def ffn_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Under a mesh the input is taken whole over its features and the
    output reduced to the batch-sharded residual layout, the tensor-parallel
    plan (DTensor's op-by-op choice can shard the residual's features and
    gather the weights whole instead); no-ops without one."""
    x = sh.shard(x, "batch", None, None)
    h = sh.product(x, p["wi"])
    if cfg.ffn == "swiglu":
        g = sh.product(x, p["wg"])
        h = F.silu(g.float()).to(h.dtype) * h
    elif cfg.ffn == "geglu":
        g = sh.product(x, p["wg"])
        h = F.gelu(g.float(), approximate="tanh").to(h.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return sh.shard(sh.product(h, p["wo"]), "batch", None, None)


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = p["table"]
    if isinstance(table, DTensor):
        # DTensor has a sharding rule for embedding and its backward; it
        # cannot propagate one for the index_put of the indexing's backward
        # (torch 2.11).  The same rows either way.  The vocab shards' masked
        # partial sums are reduced here, and the identity redistribute
        # after it takes a partial-sum gradient whole before it reaches the
        # masked partial's backward, which torch 2.11 cannot reach from a
        # partial sum.
        out = sh.shard(F.embedding(tokens, table) * math.sqrt(cfg.d_model),
                       "batch", None, None)
        return out.redistribute(out.device_mesh, out.placements)
    return table[tokens] * math.sqrt(cfg.d_model)


def unembed(p: Params, x: torch.Tensor,
            cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    logits = sh.product(x, p["head"])
    Vp = p["head"].shape[-1]
    if cfg is not None and Vp > cfg.vocab:
        # Padded vocab slots never win argmax / contribute to logsumexp.
        ids = torch.arange(Vp, device=logits.device)
        mask = torch.where(ids < cfg.vocab, 0.0, -1e30)
        logits = logits + mask.to(logits.dtype)
    return logits

"""Kernel entry points used by the model code.

``flash_attention``, ``ssm_scan``, ``rglru``, ``quantize``, ``adamw`` and
``norm`` send a CUDA tensor to their hand-written kernel and a CPU tensor to
the plain version; there is no other route.  A meta tensor (the dry run) goes to the kernel's
wrapper too, which then launches nothing and records the kernel's work
(:mod:`repro_torch.kernels.accounting`).  Under autograd, ``flash_attention``, ``ssm_scan``,
``rglru`` and ``norm`` on the card differentiate through their CUDA backward
kernels (``csrc/flash_attention_bwd.cu``, ``csrc/ssm_scan_bwd.cu``,
``csrc/rglru_scan_bwd.cu``, ``csrc/norm.cu``); on the CPU all four
differentiate through the plain versions.  The one-token decode
functions ``decode_attention``, ``ssm_step`` and ``rglru_step`` and
``dequantize`` are plain torch, as the reference's are plain jnp
(``repro.kernels.ops``).

Under a mesh (:mod:`repro_torch.models.sharding`) the model hands these five
DTensors.  Each rank then runs its own shard through the same kernel (the
CUDA kernel for a CUDA shard, the plain version only for a CPU one): the
batch and head (or channel) dims keep their shards (a norm's rows keep
every shard), and any other sharded dim (sequence, head_dim, a quantized
row's columns, a norm's features) is first gathered to ``Replicate``.
Each result is a DTensor on the same shards.  An input held whole while
another is sharded (the scans' B and C over channel shards, a
KV head shared by query heads of several ranks, a norm's scale and bias
beside sharded rows) gets a ``Partial`` gradient on those mesh dims, since
each rank's backward sees part of its uses.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.adamw import adamw_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.norm import norm_cuda
from repro_torch.kernels.quantize import quantize_cuda
from repro_torch.kernels.rglru_scan import rglru_scan_cuda
from repro_torch.kernels.ssm_scan import ssm_scan_cuda
from repro_torch.models.sharding import (from_local_even, keep_shards,
                                         local_offset, partial_where,
                                         to_local_at)

_NEG_INF = -1e30


def _flash_on_shards(q: DTensor, k, v, causal: bool, window: int,
                     scale: Optional[float]) -> DTensor:
    """Each rank's batch and query-head shard through ``flash_attention``.

    K/V keep the same batch shards, and their head shards where the KV
    heads divide the query heads' split; otherwise (``model_kv`` dropped for
    a KV count the axis does not divide) they are gathered whole and each
    rank takes the KV heads its query heads read: global query head h reads
    KV head h // (H // K), which on a rank holding heads off..off+H_loc-1 is
    not local head j // (H_loc // K_loc)."""
    mesh = q.device_mesh
    qpl = keep_shards(q, (0, 2))
    H, K = q.shape[2], k.shape[2]
    head_split = 1
    for m, pl in enumerate(qpl):
        if pl == Shard(2):
            head_split *= mesh.size(m)
    kv_split = K % head_split == 0
    kpl = tuple(pl if pl == Shard(0) or (pl == Shard(2) and kv_split)
                else Replicate() for pl in qpl)
    gpl = partial_where(qpl, kpl)
    qd = q.redistribute(mesh, qpl)
    ql = qd.to_local()
    kl, vl = to_local_at(k, mesh, kpl, gpl), to_local_at(v, mesh, kpl, gpl)
    if head_split > 1 and not kv_split:
        H_loc, rep = ql.shape[2], H // K
        off = local_offset(qd, 2)
        if H_loc % rep == 0 or rep % H_loc == 0:    # a contiguous run of KV heads
            lo = off // rep
            kl = kl[:, :, lo:lo + max(H_loc // rep, 1)]
            vl = vl[:, :, lo:lo + max(H_loc // rep, 1)]
        else:                                       # a KV head per query head
            idx = (off + torch.arange(H_loc, device=kl.device)) // rep
            kl, vl = kl[:, :, idx], vl[:, :, idx]
    o = flash_attention(ql, kl, vl, causal=causal, window=window, scale=scale)
    return from_local_even(o, mesh, qpl)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,T,H,D); k,v: (B,S,K,D), H%K==0.  The last query is aligned
    with the last key; ``window > 0`` keeps the ``window`` most recent keys."""
    if isinstance(q, DTensor):
        return _flash_on_shards(q, k, v, causal, window, scale)
    if q.is_cuda or q.is_meta:
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window, scale=scale)
    return _ref.attention_ref(q, k, v, causal=causal, window=window,
                              scale=scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: int, *, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-position attention against a (possibly padded) KV cache.

    q: (B,1,H,D); k,v: (B,S,K,D); ``cache_len`` = number of valid cache
    positions (the new token's position is ``cache_len - 1``).  A DTensor
    cache is read shard by shard (:func:`_decode_on_shards`).
    """
    if isinstance(k, DTensor):
        return _decode_on_shards(q, k, v, cache_len, window, scale)
    B, _, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    rep = H // K
    scale = scale if scale is not None else D ** -0.5
    # Query head h reads KV head h // rep, as the reference's repeat does,
    # without materializing K/V at H heads.
    qg = q.float().reshape(B, 1, K, rep, D)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qg, k.float()) * scale
    kpos = torch.arange(S, device=q.device)
    mask = kpos < cache_len
    if window > 0:
        mask &= kpos > cache_len - 1 - window
    logits = logits.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", p, v.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def _decode_on_shards(q, k: DTensor, v: DTensor, cache_len: int, window: int,
                      scale: Optional[float]) -> DTensor:
    """:func:`decode_attention` on each rank's shard of the cache.

    The query is taken on the cache's batch and head shards.  Where the
    cache is sharded over the sequence, each rank attends over its own
    slots only, keeping its max, softmax sum and p.v in f32, and those are
    combined over the sequence's mesh dims (flash-decoding's split-K
    combine): the cache is never gathered."""
    mesh, kpl = k.device_mesh, tuple(k.placements)
    qpl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in kpl)
    ql = to_local_at(q, mesh, qpl)
    kl, vl = k.to_local(), to_local_at(v, mesh, kpl)
    seq_dims = [m for m, p in enumerate(kpl) if p == Shard(1)]
    if not seq_dims:
        return from_local_even(decode_attention(ql, kl, vl, cache_len,
                                                window=window, scale=scale),
                               mesh, qpl)
    B, _, H, D = ql.shape
    S, K = kl.shape[1], kl.shape[2]
    scale = scale if scale is not None else D ** -0.5
    qg = ql.float().reshape(B, 1, K, H // K, D)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qg, kl.float()) * scale
    kpos = local_offset(k, 1) + torch.arange(S, device=kl.device)
    mask = kpos < cache_len
    if window > 0:
        mask &= kpos > cache_len - 1 - window
    logits = logits.masked_fill(~mask, _NEG_INF)
    m = logits.amax(dim=-1)                                   # (B,K,r,1)
    p = torch.exp(logits - m[..., None])
    lsum = p.sum(dim=-1)
    acc = torch.einsum("bkrqs,bskd->bkrqd", p, vl.float())
    for d in seq_dims:
        group = mesh.get_group(d)
        top = funcol.all_reduce(m, "max", group)
        corr = torch.exp(m - top)
        lsum = funcol.all_reduce(lsum * corr, "sum", group)
        acc = funcol.all_reduce(acc * corr[..., None], "sum", group)
        m = top
    out = (acc / lsum[..., None]).permute(0, 3, 1, 2, 4).reshape(B, 1, H, D)
    return from_local_even(out.to(ql.dtype), mesh, qpl)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba1 selective scan.  Shapes as :func:`ref.ssm_scan_ref`."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        xpl = keep_shards(x, (0, 2))                   # batch, channels
        chan = tuple(Shard(0) if p == Shard(2) else Replicate() for p in xpl)
        bat = tuple(p if p == Shard(0) else Replicate() for p in xpl)
        state = tuple(Shard(1) if p == Shard(2) else p for p in xpl)
        y, hT = ssm_scan(*(to_local_at(t, mesh, pl, partial_where(xpl, pl)) for t, pl in (
            (x, xpl), (dt, xpl), (A, chan), (B, bat), (C, bat), (D, chan))),
            to_local_at(h0, mesh, state))
        return from_local_even(y, mesh, xpl), from_local_even(hT, mesh, state)
    if x.is_cuda or x.is_meta:
        return ssm_scan_cuda(x.contiguous(), dt, A, B, C, D, h0)
    return _ref.ssm_scan_ref(x, dt, A, B, C, D, h0)


def ssm_step(xt: torch.Tensor, dtt: torch.Tensor, A: torch.Tensor,
             Bt_: torch.Tensor, Ct: torch.Tensor, D: torch.Tensor,
             h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  xt, dtt: (B,I); Bt_, Ct: (B,N); h: (B,I,N)."""
    xf, dtf = xt.float(), dtt.float()
    dA = torch.exp(dtf[..., None] * A[None])                 # (B,I,N)
    dBx = dtf[..., None] * Bt_.float()[:, None, :] * xf[..., None]
    h = dA * h.float() + dBx
    y = torch.einsum("bin,bn->bi", h, Ct.float()) + xf * D[None].float()
    return y.to(xt.dtype), h


def rglru(x: torch.Tensor, a_gate: torch.Tensor, i_gate: torch.Tensor,
          log_lam: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
          c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU over a sequence.  Shapes as :func:`ref.rglru_ref`."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        xpl = keep_shards(x, (0, 2))                   # batch, channels
        chan = tuple(Shard(0) if p == Shard(2) else Replicate() for p in xpl)
        state = tuple(Shard(1) if p == Shard(2) else p for p in xpl)
        hs, hT = rglru(*(to_local_at(t, mesh, pl, partial_where(xpl, pl)) for t, pl in (
            (x, xpl), (a_gate, xpl), (i_gate, xpl), (log_lam, chan))),
            to_local_at(h0, mesh, state), c=c)
        return from_local_even(hs, mesh, xpl), from_local_even(hT, mesh, state)
    if x.is_cuda or x.is_meta:
        return rglru_scan_cuda(x.contiguous(), a_gate.contiguous(),
                               i_gate.contiguous(), log_lam, h0, c=c)
    return _ref.rglru_ref(x, a_gate, i_gate, log_lam, h0, c=c)


def rglru_step(xt: torch.Tensor, a_gate: torch.Tensor, i_gate: torch.Tensor,
               log_lam: torch.Tensor, h: torch.Tensor, *, c: float = 8.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  xt, gates: (B,L); h: (B,L)."""
    xf = xt.float()
    lam = F.softplus(log_lam.float())
    log_a = -c * lam[None] * torch.sigmoid(a_gate.float())
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    h = a * h.float() + mult * torch.sigmoid(i_gate.float()) * xf
    return h.to(xt.dtype), h


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of x (R,C): (int8 (R,C), f32
    scales (R,1)).  A DTensor keeps its row shards."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        pl = keep_shards(x, (0,))
        q, s = quantize(to_local_at(x, mesh, pl))
        return from_local_even(q, mesh, pl), from_local_even(s, mesh, pl)
    if x.is_cuda or x.is_meta:
        return quantize_cuda(x)
    return _ref.quantize_ref(x)


def adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
          clip: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor, *,
          lr: float, b1: float, b2: float, eps: float, weight_decay: float,
          decay: bool) -> None:
    """One AdamW step of one leaf's local tensors, in place: p, m and v.
    clip, bc1 and bc2 are 0-d f32 tensors on p's device; decoupled weight
    decay when ``decay``.  The plain version is the optimizer's slice loop
    (:func:`repro_torch.train.optimizer.update_in_slices`)."""
    hyper = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 decay=decay)
    if p.is_cuda or p.is_meta:
        return adamw_cuda(p, g, m, v, clip, bc1, bc2, **hyper)
    # Imported here: the optimizer imports this module.
    from repro_torch.train.optimizer import update_in_slices
    return update_in_slices(p, g, m, v, clip, bc1, bc2, **hyper)


def norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
         kind: str, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (``kind="layernorm"``, an f32 bias (C,)) or RMSNorm
    (``"rmsnorm"``, bias None) over the last dim of x with an f32 scale
    (C,); the result in x's dtype.  The plain version is
    :func:`ref.norm_ref`."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        xpl = keep_shards(x, range(x.ndim - 1))        # rows; the features whole
        wpl = (Replicate(),) * mesh.ndim
        gpl = partial_where(xpl, wpl)
        y = norm(to_local_at(x, mesh, xpl), to_local_at(scale, mesh, wpl, gpl),
                 to_local_at(bias, mesh, wpl, gpl), kind, eps)
        return from_local_even(y, mesh, xpl)
    if x.is_cuda or x.is_meta:
        return norm_cuda(x, scale, bias, kind, eps)
    return _ref.norm_ref(x, scale, bias, kind, eps)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _ref.dequantize_ref(q, scale, dtype)

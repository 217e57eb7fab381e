"""Plain PyTorch oracles for the kernels in :mod:`repro_torch.kernels`.

Copied from ``repro.kernels.ref``: small-shape, full-materialization, no
tiling.  They are the CPU path of the wrappers and what ``chip_smoke.py``
holds each CUDA kernel against on the card.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Full softmax attention.  q: (B,T,H,D); k,v: (B,S,K,D) with H%K==0.

    Query row t sits at position ``S-T+t`` (suffix queries).  A row with no
    visible key returns 0.
    """
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    rep = H // K
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    qpos = torch.arange(T, device=q.device)[:, None] + (S - T)
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)             # fully-masked rows
    out = torch.einsum("bhts,bshd->bthd", p, v.float())
    return out.to(q.dtype)

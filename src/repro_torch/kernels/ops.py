"""Kernel entry points used by the model code.

``flash_attention`` sends a CUDA tensor to the hand-written kernel and a CPU
tensor to the plain version; there is no other route.  ``decode_attention``
is plain torch, as the reference's is plain jnp (``repro.kernels.ops``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention_cuda

_NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,T,H,D); k,v: (B,S,K,D), H%K==0.  The last query is aligned
    with the last key; ``window > 0`` keeps the ``window`` most recent keys."""
    if q.is_cuda:
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
    positions (the new token's position is ``cache_len - 1``).
    """
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

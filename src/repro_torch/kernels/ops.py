"""Kernel entry points used by the model code.

``flash_attention``, ``ssm_scan``, ``rglru`` and ``quantize`` send a CUDA
tensor to their hand-written kernel and a CPU tensor to the plain version;
there is no other route.  Under autograd, ``flash_attention``, ``ssm_scan``
and ``rglru`` on the card differentiate through their CUDA backward kernels
(``csrc/flash_attention_bwd.cu``, ``csrc/ssm_scan_bwd.cu``,
``csrc/rglru_scan_bwd.cu``); on the CPU all three differentiate through the
plain versions.  The one-token decode
functions ``decode_attention``, ``ssm_step`` and ``rglru_step`` and
``dequantize`` are plain torch, as the reference's are plain jnp
(``repro.kernels.ops``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.quantize import quantize_cuda
from repro_torch.kernels.rglru_scan import rglru_scan_cuda
from repro_torch.kernels.ssm_scan import ssm_scan_cuda

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


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba1 selective scan.  Shapes as :func:`ref.ssm_scan_ref`."""
    if x.is_cuda:
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
    if x.is_cuda:
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
    scales (R,1))."""
    if x.is_cuda:
        return quantize_cuda(x)
    return _ref.quantize_ref(x)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _ref.dequantize_ref(q, scale, dtype)

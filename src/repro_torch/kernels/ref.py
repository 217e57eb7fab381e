"""Plain PyTorch oracles for the kernels in :mod:`repro_torch.kernels`.

Copied from ``repro.kernels.ref``: small-shape, full-materialization, no
tiling.  They are the CPU path of the wrappers and what ``chip_smoke.py``
holds each CUDA kernel against on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba1 selective scan, sequential.

    x, dt: (Bt,T,I);  A: (I,N);  B, C: (Bt,T,N);  D: (I,).
    h_t = exp(dt_t*A) h_{t-1} + dt_t * B_t * x_t;  y_t = C_t . h_t + D * x_t.
    All math in f32; ``D*x`` is added in f32 before the cast to x's dtype.
    Returns (y (Bt,T,I) in x's dtype, h_T (Bt,I,N) f32).  The reference
    materializes exp(dt*A) for every step at once; here it is formed one
    step at a time, which is the same arithmetic in less memory.
    """
    Bt, T, I = x.shape
    N = A.shape[1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = B.float(), C.float()
    h = (h0.float().clone() if h0 is not None
         else torch.zeros((Bt, I, N), dtype=torch.float32, device=x.device))
    ys = torch.empty((Bt, T, I), dtype=torch.float32, device=x.device)
    for t in range(T):
        dA = torch.exp(dtf[:, t, :, None] * Af)                # (Bt,I,N)
        dBx = dtf[:, t, :, None] * Bf[:, t, None, :] * xf[:, t, :, None]
        h = dA * h + dBx
        ys[:, t] = torch.einsum("bin,bn->bi", h, Cf[:, t])
    y = ys + xf * D.float()
    return y.to(x.dtype), h


def rglru_ref(x: torch.Tensor, a_gate: torch.Tensor, i_gate: torch.Tensor,
              log_lam: torch.Tensor, h0: Optional[torch.Tensor] = None,
              c: float = 8.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU (Griffin eq. 3-4), sequential over exactly T steps.

    x, a_gate, i_gate: (B,T,L), gates pre-sigmoid;  log_lam: (L,).
    h_t = a_t * h_{t-1} + sqrt(1-a_t^2) * sigmoid(i_t) * x_t,
    a_t = exp(-c * softplus(log_lam) * sigmoid(a_gate_t)).
    Returns (h sequence (B,T,L) in x's dtype, h_T (B,L) f32).
    """
    B, T, L = x.shape
    lam = F.softplus(log_lam.float())
    log_a = -c * lam * torch.sigmoid(a_gate.float())
    a = torch.exp(log_a)
    # sqrt(1 - a^2) from log_a, clamped away from 0 as in the reference
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    inp = mult * (torch.sigmoid(i_gate.float()) * x.float())
    h = (h0.float().clone() if h0 is not None
         else torch.zeros((B, L), dtype=torch.float32, device=x.device))
    hs = torch.empty((B, T, L), dtype=torch.float32, device=x.device)
    for t in range(T):
        h = a[:, t] * h + inp[:, t]
        hs[:, t] = h
    return hs.to(x.dtype), h


def quantize_ref(x: torch.Tensor, axis: int = -1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization.  Returns (int8 codes, f32 scales
    with ``axis`` kept as size 1): scale = amax/127 (1 where amax is 0),
    q = clip(round(x/scale), -127, 127), rounding half to even."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    # A tensor divisor, not the Python scalar 127.0: CUDA torch divides by a
    # scalar as a multiply by its reciprocal, which can miss amax/127 by an
    # ulp and move a code that sits on a rounding tie.
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def norm_ref(x: torch.Tensor, scale: torch.Tensor,
             bias: Optional[torch.Tensor], kind: str,
             eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (``kind="layernorm"``, with ``bias``) or RMSNorm (no bias)
    over the last dim, as the reference's ``apply_norm`` / ``_qk_normalize``:
    x taken to f32, the chain of ops below, the result cast back to x's
    dtype."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    else:
        y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps)
        y = y * scale
    return y.to(x.dtype)

"""Mamba1 block (falcon-mamba-7b): gated selective-state-space mixer.

Ported from ``repro.models.ssm``.  x -> in_proj -> (u, z); u -> causal
depthwise conv -> silu -> selective scan (:func:`repro_torch.kernels.ops.ssm_scan`,
the CUDA kernel on the card) -> gate by silu(z) -> out_proj.  With
``cfg.mamba_dt_bc_norm`` (Jamba, port-only) dt, B and C each pass an RMSNorm
with a learned scale after ``x_proj``.  The full-sequence mixer runs inside
the span ``repro_torch.mamba.mix`` (:func:`repro_torch.obs.region`), its
backward too.  Decode keeps
(conv window of pre-conv inputs u, ssm state) as the recurrent cache, O(1)
in context length.  :func:`mamba_spec` and :func:`mamba_cache_spec` are the
reference's logical sharding specs; under a mesh the scan runs on each
rank's shard of batch and channels (:func:`repro_torch.kernels.ops.ssm_scan`
on DTensors).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import P

Params = L.Params
_DT_BC_NORMS = ("dt_norm", "b_norm", "c_norm")    # scales of dt (R), B and C (N)


def mamba_params(cfg: ModelConfig) -> L.Shapes:
    D, I, R, N = cfg.d_model, cfg.inner, cfg.dtrank, cfg.ssm_state
    f32 = torch.float32
    p = {
        "in_proj": ((D, 2 * I), cfg.dtype),
        "conv_w": ((cfg.ssm_conv, I), cfg.dtype),
        "conv_b": ((I,), f32),
        "x_proj": ((I, R + 2 * N), cfg.dtype),
        "dt_proj": ((R, I), cfg.dtype),
        "dt_bias": ((I,), f32),
        "A_log": ((I, N), f32),
        "D": ((I,), f32),
        "out_proj": ((I, D), cfg.dtype),
    }
    if cfg.mamba_dt_bc_norm:
        p.update({n: ((w,), f32) for n, w in zip(_DT_BC_NORMS, (R, N, N))})
    return p


def mamba_spec(cfg: ModelConfig) -> Dict[str, P]:
    p = {
        "in_proj": P("fsdp", "model"),
        "conv_w": P(None, "model"),
        "conv_b": P("model"),
        "x_proj": P("model", None),
        "dt_proj": P(None, "model"),
        "dt_bias": P("model"),
        "A_log": P("model", None),
        "D": P("model"),
        "out_proj": P("model", "fsdp"),
    }
    if cfg.mamba_dt_bc_norm:
        p.update({n: P(None) for n in _DT_BC_NORMS})
    return p


def mamba_cache_spec(cfg: ModelConfig) -> Dict[str, P]:
    return {"conv": P("batch", None, "model"), "h": P("batch", "model", None)}


def mamba_init_(p: Params, cfg: ModelConfig, generator: torch.Generator) -> None:
    """The reference's ``mamba_init``: S4D-real A, dt bias softplus^-1(~0.01)."""
    I, N = cfg.inner, cfg.ssm_state
    for name, fan_in in (("in_proj", cfg.d_model), ("conv_w", cfg.ssm_conv),
                         ("x_proj", I), ("dt_proj", cfg.dtrank), ("out_proj", I)):
        L.dense_(p[name], fan_in, generator)
    p["conv_b"].zero_()
    p["dt_bias"].fill_(-4.6)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=p["A_log"].device)
    p["A_log"].copy_(torch.log(A).expand(I, N))
    p["D"].fill_(1.0)
    for name in _DT_BC_NORMS:
        if name in p:
            p[name].fill_(1.0)


def _split_xproj(p: Params, u: torch.Tensor, cfg: ModelConfig):
    R, N = cfg.dtrank, cfg.ssm_state
    proj = sh.product(u, p["x_proj"])
    # Under a mesh the channels' partial sums are reduced here, so dt comes
    # out on the channel shards of its bias (no-op without one).
    proj = sh.shard(proj, "batch", *([None] * (proj.ndim - 1)))
    dt_r, B, C = torch.split(proj, [R, N, N], dim=-1)
    if cfg.mamba_dt_bc_norm:
        dt_r, B, C = (L._qk_normalize(t, p[n])
                      for t, n in zip((dt_r, B, C), _DT_BC_NORMS))
    dt = F.softplus(sh.product(dt_r, p["dt_proj"]).float() + p["dt_bias"])
    return dt, B, C


def _in_proj(p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, z), the two halves of ``x @ in_proj``.  Under a mesh a product
    sharded over its 2I columns would hold the halves on different ranks:
    for a sequence each half is a product of its own on the channel shards
    (the weight's halves are laid out again, fewer bytes than the
    activations); a one-position step's halves are laid out again."""
    w = p["in_proj"]
    if not isinstance(x, DTensor) or x.shape[1] == 1:
        return torch.chunk(sh.product(x, w), 2, dim=-1)
    u_w, z_w = (h.redistribute(w.device_mesh, w.placements)
                for h in torch.chunk(w, 2, dim=-1))
    return sh.product(x, u_w), sh.product(x, z_w)


def mamba_mix(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mixer over a full sequence.  x: (B,T,D).  Returns (out (B,T,D),
    the pre-conv inputs u (B,T,I), the final ssm state (B,I,N) f32)."""
    return obs.region(obs.MAMBA_MIX, _mix, p, x, cfg)


def _mix(p: Params, x: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    u, z = _in_proj(p, x)                                 # (B,T,I) each
    conv = L.causal_conv(u, p["conv_w"], p["conv_b"])
    uc = F.silu(conv.float()).to(x.dtype)
    dt, Bm, Cm = _split_xproj(p, uc, cfg)
    A = -torch.exp(p["A_log"])                            # (I,N), negative
    y, hT = ops.ssm_scan(uc, dt, A, Bm, Cm, p["D"])
    y = y * F.silu(z.float()).to(y.dtype)
    return sh.shard(sh.product(y, p["out_proj"]), "batch", None, None), u, hT


def mamba_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Train / prefill over a full sequence.  x: (B,T,D)."""
    return mamba_mix(p, x, cfg)[0]


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """Zero decode state; sharded on its spec under active rules."""
    spec = mamba_cache_spec(cfg)
    return {
        "conv": sh.zeros((batch, cfg.ssm_conv - 1, cfg.inner), dtype, device,
                         spec["conv"]),
        "h": sh.zeros((batch, cfg.inner, cfg.ssm_state), torch.float32, device,
                      spec["h"]),
    }


def mamba_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token.  x: (B,1,D); cache: conv window (B,W-1,I) + state (B,I,N)."""
    u, z = _in_proj(p, x)                                 # (B,1,I)
    window = torch.cat([cache["conv"], u], dim=1)         # (B,W,I)
    conv = (torch.einsum("bwi,wi->bi", window, p["conv_w"])
            + p["conv_b"].to(u.dtype))
    ut = F.silu(conv.float()).to(x.dtype)                 # (B,I)
    dt, Bm, Cm = _split_xproj(p, ut, cfg)
    A = -torch.exp(p["A_log"])
    yt, h = ops.ssm_step(ut, dt, A, Bm, Cm, p["D"], cache["h"])
    yt = yt * F.silu(z[:, 0].float()).to(yt.dtype)
    y = sh.shard(sh.product(yt, p["out_proj"]), "batch", None)[:, None]
    return y, {"conv": window[:, 1:], "h": h}

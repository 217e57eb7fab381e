"""RecurrentGemma recurrent block: conv + RG-LRU gated linear recurrence.

Ported from ``repro.models.rglru``.  Griffin-style: x -> two branches;
branch 1: linear -> GeLU (gate); branch 2: linear -> causal conv (width 4)
-> RG-LRU (:func:`repro_torch.kernels.ops.rglru`, the CUDA kernel on the
card); merge by product -> out projection.  Decode state is (conv window,
lru hidden), O(1) in context.  :func:`rglru_spec` and :func:`rglru_cache_spec`
are the reference's logical sharding specs; under a mesh the RG-LRU runs on
each rank's shard of batch and channels (:func:`repro_torch.kernels.ops.rglru`
on DTensors).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import P

Params = L.Params
CONV_W = 4


def rglru_params(cfg: ModelConfig) -> L.Shapes:
    D, Lw = cfg.d_model, cfg.lru
    f32 = torch.float32
    return {
        "w_gate": ((D, Lw), cfg.dtype),
        "w_rec": ((D, Lw), cfg.dtype),
        "conv_w": ((CONV_W, Lw), cfg.dtype),
        "conv_b": ((Lw,), f32),
        "w_a": ((Lw, Lw), cfg.dtype),
        "w_i": ((Lw, Lw), cfg.dtype),
        "log_lam": ((Lw,), f32),
        "w_out": ((Lw, D), cfg.dtype),
    }


def rglru_spec(cfg: ModelConfig) -> Dict[str, P]:
    return {
        "w_gate": P("fsdp", "model"),
        "w_rec": P("fsdp", "model"),
        "conv_w": P(None, "model"),
        "conv_b": P("model"),
        "w_a": P(None, "model"),
        "w_i": P(None, "model"),
        "log_lam": P("model"),
        "w_out": P("model", "fsdp"),
    }


def rglru_cache_spec(cfg: ModelConfig) -> Dict[str, P]:
    return {"conv": P("batch", None, "model"), "h": P("batch", "model")}


def rglru_init_(p: Params, cfg: ModelConfig, generator: torch.Generator) -> None:
    """The reference's ``rglru_init``: lambda such that a ~ U(0.9, 0.999) at
    zero gate input."""
    D, Lw = cfg.d_model, cfg.lru
    for name, fan_in in (("w_gate", D), ("w_rec", D), ("conv_w", CONV_W),
                         ("w_a", Lw), ("w_i", Lw), ("w_out", Lw)):
        L.dense_(p[name], fan_in, generator)
    p["conv_b"].zero_()
    lam0 = torch.linspace(0.12, 0.9, Lw, dtype=torch.float32,
                          device=p["log_lam"].device)
    p["log_lam"].copy_(torch.log(torch.expm1(lam0)))      # softplus^-1


def _branches(p: Params, x: torch.Tensor):
    return sh.product(x, p["w_gate"]), sh.product(x, p["w_rec"])


def _gates(p: Params, conv: torch.Tensor):
    """The a- and i-gate products of the conv output.  Under a mesh the
    conv output is gathered over its channel shards once for both, and each
    gate comes out on the channel shards of its weight's columns."""
    conv = sh.shard(conv, "batch", *([None] * (conv.ndim - 1)))
    return sh.product(conv, p["w_a"]), sh.product(conv, p["w_i"])


def rglru_mix(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mixer over a full sequence.  x: (B,T,D).  Returns (out (B,T,D),
    the pre-conv branch rec (B,T,L), the final hidden state (B,L) f32)."""
    gate, rec = _branches(p, x)
    gate = F.gelu(gate.float(), approximate="tanh").to(x.dtype)
    conv = L.causal_conv(rec, p["conv_w"], p["conv_b"])
    a_gate, i_gate = _gates(p, conv)
    hs, hT = ops.rglru(conv, a_gate, i_gate, p["log_lam"])
    y = hs * gate
    return sh.shard(sh.product(y, p["w_out"]), "batch", None, None), rec, hT


def rglru_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Train / prefill.  x: (B,T,D)."""
    return rglru_mix(p, x, cfg)[0]


def rglru_cache_init(cfg: ModelConfig, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """Zero decode state; sharded on its spec under active rules."""
    spec = rglru_cache_spec(cfg)
    return {
        "conv": sh.zeros((batch, CONV_W - 1, cfg.lru), dtype, device, spec["conv"]),
        "h": sh.zeros((batch, cfg.lru), torch.float32, device, spec["h"]),
    }


def rglru_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token.  x: (B,1,D)."""
    gate, rec = _branches(p, x)                           # (B,1,L)
    gate = F.gelu(gate.float(), approximate="tanh").to(x.dtype)
    window = torch.cat([cache["conv"], rec], dim=1)       # (B,W,L)
    conv = (torch.einsum("bwl,wl->bl", window, p["conv_w"])
            + p["conv_b"].to(rec.dtype))
    a_gate, i_gate = _gates(p, conv)
    _, h = ops.rglru_step(conv, a_gate, i_gate, p["log_lam"], cache["h"])
    y = h.to(x.dtype) * gate[:, 0]
    out = sh.shard(sh.product(y, p["w_out"]), "batch", None)[:, None]
    return out, {"conv": window[:, 1:], "h": h}

"""Batched greedy serving: prefill the prompt, then one-token decode steps.

Ported from ``repro.serve.decode``.  The model object carries its config and
parameters, so the factories take it in place of the reference's
``(cfg, params)`` pair.  Argmax is taken on f32 logits, as in the reference.

A vision arch's prefill prepends its P projected patches, so the prompt's
tokens sit at positions P..P+Tp-1 and the first decoded token at P+Tp:
:func:`generate` sizes the cache ``P + Tp + steps`` and starts decoding at
index ``P + Tp`` (:func:`prefix_len`).  The reference's ``generate`` sizes
it ``Tp + steps`` and starts at ``Tp``, so there the first decoded token
overwrites a prompt position's K/V and takes its RoPE position.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.models.sharding import shard
from repro_torch.models.transformer import Transformer


def prefix_len(model: Transformer, **extras) -> int:
    """Positions that the prefill puts in front of the prompt's tokens: the
    patches of a vision arch given ``patches``, else 0."""
    patches = extras.get("patches")
    if model.cfg.frontend == "vision" and patches is not None:
        return patches.shape[1]
    return 0


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax of the last position's f32 logits; under a mesh the vocab
    shards are gathered first (no-op without one)."""
    return torch.argmax(shard(logits[:, -1].float(), "batch", None), dim=-1)


def make_prefill(model: Transformer, max_len: int):
    def prefill(tokens: torch.Tensor, **extras):
        """tokens: (B,Tp); extras: ``frames`` / ``patches``."""
        with obs.span(obs.PREFILL):
            logits, cache = model.prefill(tokens, max_len, **extras)
            return _greedy(logits), logits, cache
    return prefill


def make_serve_step(model: Transformer):
    def serve_step(cache, tokens: torch.Tensor, index: int):
        """tokens: (B,1) current token; index: its position.  Greedy argmax."""
        logits, cache = model.decode_step(cache, tokens, index)
        return _greedy(logits), logits, cache
    return serve_step


@torch.inference_mode()
def generate(model: Transformer, prompt: torch.Tensor, steps: int,
             max_len: Optional[int] = None, **extras) -> torch.Tensor:
    """Greedy generation: (B,Tp) prompt -> (B,steps) tokens; ``extras``
    are the arch's ``frames`` / ``patches``."""
    B, Tp = prompt.shape
    start = prefix_len(model, **extras) + Tp
    max_len = max_len or (start + steps)
    prefill = make_prefill(model, max_len)
    step = make_serve_step(model)
    tok, _, cache = prefill(prompt, **extras)
    out = [tok]
    for i in range(steps - 1):
        tok, _, cache = step(cache, tok[:, None], start + i)
        out.append(tok)
    return torch.stack(out, dim=1)

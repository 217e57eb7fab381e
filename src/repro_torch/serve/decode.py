"""Batched greedy serving: prefill the prompt, then one-token decode steps.

Ported from ``repro.serve.decode``.  The model object carries its config and
parameters, so the factories take it in place of the reference's
``(cfg, params)`` pair.  Argmax is taken on f32 logits, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.transformer import Transformer


def make_prefill(model: Transformer, max_len: int):
    def prefill(tokens: torch.Tensor):
        logits, cache = model.prefill(tokens, max_len)
        next_tok = torch.argmax(logits[:, -1].float(), dim=-1)
        return next_tok, logits, cache
    return prefill


def make_serve_step(model: Transformer):
    def serve_step(cache, tokens: torch.Tensor, index: int):
        """tokens: (B,1) current token; index: its position.  Greedy argmax."""
        logits, cache = model.decode_step(cache, tokens, index)
        next_tok = torch.argmax(logits[:, -1].float(), dim=-1)
        return next_tok, logits, cache
    return serve_step


@torch.inference_mode()
def generate(model: Transformer, prompt: torch.Tensor, steps: int,
             max_len: Optional[int] = None) -> torch.Tensor:
    """Greedy generation: (B,Tp) prompt -> (B,steps) tokens."""
    B, Tp = prompt.shape
    max_len = max_len or (Tp + steps)
    prefill = make_prefill(model, max_len)
    step = make_serve_step(model)
    tok, _, cache = prefill(prompt)
    out = [tok]
    for i in range(steps - 1):
        tok, _, cache = step(cache, tok[:, None], Tp + i)
        out.append(tok)
    return torch.stack(out, dim=1)

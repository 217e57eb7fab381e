"""Token batches for the train step.

Ported from ``repro.data.pipeline``: :func:`synthetic_batch` gives random
(tokens, labels) batches with next-token labels, ``labels = roll(tokens,
-1)`` as the reference's.  The reference draws them from a ``jax.random``
key; here they come from an int seed or a ``torch.Generator``, so the
numbers differ and tests feed both packages one numpy batch.  Audio and
vision inputs wait for the encoder-decoder and vision slice;
``TokenPipeline`` comes with the checkpoint / BaseFS slice.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from repro_torch.models.config import ModelConfig


def synthetic_batch(seed: Union[int, torch.Generator], cfg: ModelConfig,
                    batch: int, seq: int, device="cuda"
                    ) -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"}: (batch, seq) int64 on ``device`` (the card
    unless the caller asks for the CPU), tokens uniform in [0, vocab).  An
    int seed makes a generator on ``device``; a given generator must live
    there."""
    if cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.frontend} frontend inputs are not yet ported "
            "(encoder-decoder and vision slice)")
    gen = (torch.Generator(device=device).manual_seed(seed)
           if isinstance(seed, int) else seed)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         device=device)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}

"""Token batches for the train step.

Ported from ``repro.data.pipeline``.  :class:`TokenPipeline` feeds the
train step from a :class:`~repro_torch.data.dlio.PreloadedStore`: samples
are fixed-length int32 token sequences stored as bytes in the burst-buffer
store, read through the consistency layer in the order of the store's
``epoch_assignment``, and assembled into (tokens, labels) batches with
next-token labels, ``labels = roll(tokens, -1)``.  :func:`make_token_samples`
makes the corpus from an int seed (the reference derives that int from a
``jax.random`` key).

:func:`synthetic_batch` gives random batches for smoke runs and the
launcher.  The reference draws them from a ``jax.random`` key; here they
come from an int seed or a ``torch.Generator``, so the numbers differ and
tests feed both packages one numpy batch.  Audio and vision inputs wait
for the encoder-decoder and vision slice.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Union

import numpy as np
import torch

from repro_torch.data.dlio import PreloadedStore
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


def make_token_samples(seed: int, n: int, seq: int, vocab: int
                       ) -> List[np.ndarray]:
    """Deterministic corpus of ``n`` fixed-length int32 sequences, drawn
    from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(seq,), dtype=np.int32)
            for _ in range(n)]


class TokenPipeline:
    """Feeds train_step from a PreloadedStore, epoch by epoch.

    Every sample byte-string that reaches a batch came through the
    consistency layer (local or cross-host burst-buffer read), so data-
    ingest I/O counts appear in the store's ledger alongside training.
    Batches are int64 on ``device``: the card unless the caller asks for
    the CPU.
    """

    def __init__(self, store: PreloadedStore, cfg: ModelConfig,
                 batch_size: int, seq: int, seed: int = 0,
                 device="cuda") -> None:
        self.store = store
        self.cfg = cfg
        self.B = batch_size
        self.seq = seq
        self.seed = seed
        self.device = torch.device(device)

    def batches(self, epoch: int, reader_host: int = 0
                ) -> Iterator[Dict[str, torch.Tensor]]:
        assign = self.store.epoch_assignment(epoch, self.seed)
        flat = [i for sub in assign for i in sub]
        for b0 in range(0, len(flat) - self.B + 1, self.B):
            toks = []
            for idx in flat[b0 : b0 + self.B]:
                raw = self.store.read_sample(idx, reader_host=reader_host)
                toks.append(np.frombuffer(raw, np.int32)[: self.seq])
            tokens = torch.from_numpy(np.stack(toks)).to(self.device,
                                                         torch.int64)
            yield {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}

"""Modality frontend stubs: the archs' non-token inputs.

Ported from ``repro.models.frontends``.  ``[audio]`` (whisper) and
``[vlm]`` (paligemma) archs take precomputed frame / patch embeddings; the
conv frontend and the SigLIP tower are out of scope, as in the reference.
Each helper draws N(0,1)·0.02 in f32 from an explicit ``torch.Generator``
on ``device`` and casts it to ``cfg.dtype``.  The reference's abstract
branch (a ``ShapeDtypeStruct`` stand-in when no key is given, for its
dry-run ``input_specs``) is left out: the port has no dry run.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.config import ModelConfig


def _stub(shape, cfg: ModelConfig, generator: torch.Generator,
          device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * 0.02).to(cfg.dtype)


def audio_frames(cfg: ModelConfig, batch: int, generator: torch.Generator,
                 device="cuda") -> torch.Tensor:
    """(batch, enc_len, d_model) stub audio-frontend embeddings."""
    return _stub((batch, cfg.enc_len, cfg.d_model), cfg, generator, device)


def vision_patches(cfg: ModelConfig, batch: int, generator: torch.Generator,
                   device="cuda") -> torch.Tensor:
    """(batch, vision_patches, d_model) stub vision embeddings."""
    return _stub((batch, cfg.vision_patches, cfg.d_model), cfg, generator,
                 device)


def extra_inputs(cfg: ModelConfig, batch: int, generator: torch.Generator,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """The non-token inputs an arch needs, keyed by ``forward``'s keyword
    (``frames`` or ``patches``); empty for a text-only arch."""
    if cfg.frontend == "audio":
        return {"frames": audio_frames(cfg, batch, generator, device)}
    if cfg.frontend == "vision":
        return {"patches": vision_patches(cfg, batch, generator, device)}
    return {}

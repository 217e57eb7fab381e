"""Load the reference's parameter tree into the port.

The reference (``repro.models.transformer.init_params``) keeps a pytree of
nested dicts whose ``blocks`` leaves carry a leading ``n_super`` axis.  Given
that tree as nested dicts of numpy arrays (``jax.device_get`` of it), this
module builds the port's ``state_dict``: layer ``i`` takes index ``i`` of
``blocks.b0``.  bf16 arrays (an ``ml_dtypes`` dtype) are reinterpreted bit
for bit, so this package never imports ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def to_tensor(a: Any) -> torch.Tensor:
    """A numpy array (f32, int, or ml_dtypes bfloat16) as a CPU tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_reference(tree: Mapping[str, Any],
                          cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Reference parameter tree -> the port's ``Transformer`` state_dict."""
    if tuple(cfg.pattern) != ("attn",):
        raise NotImplementedError(f"pattern {cfg.pattern} is not yet ported")
    sd: Dict[str, torch.Tensor] = {}
    for group in ("embed", "final_norm"):
        for leaf, a in tree[group].items():
            sd[f"{group}.{leaf}"] = to_tensor(a)
    block = tree["blocks"]["b0"]
    for i in range(cfg.n_layers):
        for group, leaves in block.items():
            for leaf, a in leaves.items():
                sd[f"layers.{i}.{group}.{leaf}"] = to_tensor(np.asarray(a)[i])
    return sd

"""Load the reference's parameter tree into the port.

The reference (``repro.models.transformer.init_params``) keeps a pytree of
nested dicts whose ``blocks.b{i}`` leaves (block ``i`` of the pattern) carry
a leading ``n_super`` axis, and unstacked ``rem{i}`` blocks for the pattern
remainder.  Given that tree as nested dicts of numpy arrays
(``jax.device_get`` of it), this module builds the port's ``state_dict``:
with ``P = len(cfg.pattern)``, port layer ``s*P + i`` takes index ``s`` of
``blocks.b{i}`` and layer ``n_super*P + i`` takes ``rem{i}``.  bf16 arrays
(an ``ml_dtypes`` dtype) are reinterpreted bit for bit, so this package
never imports ``ml_dtypes``.
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
    if cfg.kind != "decoder" or cfg.is_moe or cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: only decoders without MoE or "
                                  "a frontend are ported")
    sd: Dict[str, torch.Tensor] = {}
    for group in ("embed", "final_norm"):
        for leaf, a in tree[group].items():
            sd[f"{group}.{leaf}"] = to_tensor(a)

    def put(layer: int, block: Mapping[str, Any], index=None) -> None:
        for group, leaves in block.items():
            for leaf, a in leaves.items():
                a = np.asarray(a)
                sd[f"layers.{layer}.{group}.{leaf}"] = to_tensor(
                    a if index is None else a[index])

    P = len(cfg.pattern)
    for s in range(cfg.n_super):
        for i in range(P):
            put(s * P + i, tree["blocks"][f"b{i}"], s)
    for i in range(len(cfg.remainder)):
        put(cfg.n_super * P + i, tree[f"rem{i}"])
    return sd

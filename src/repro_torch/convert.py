"""Load the reference's parameter tree (and AdamW state) into the port.

The reference (``repro.models.transformer.init_params``) keeps a pytree of
nested dicts whose ``blocks.b{i}`` leaves (block ``i`` of the pattern) carry
a leading ``n_super`` axis, and unstacked ``rem{i}`` blocks for the pattern
remainder.  Given that tree as nested dicts of numpy arrays
(``jax.device_get`` of it), this module builds the port's ``state_dict``:
with ``P = len(cfg.pattern)``, port layer ``s*P + i`` takes index ``s`` of
``blocks.b{i}`` and layer ``n_super*P + i`` takes ``rem{i}``.  bf16 arrays
(an ``ml_dtypes`` dtype) are reinterpreted bit for bit, so this package
never imports ``ml_dtypes``.  :func:`reference_path` gives that map for
one port parameter name, so gradients and updates compare leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer


def to_tensor(a: Any) -> torch.Tensor:
    """A numpy array (f32, int, or ml_dtypes bfloat16) as a CPU tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_reference(tree: Mapping[str, Any],
                          cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Reference parameter tree -> the port's ``Transformer`` state_dict
    (raises ``NotImplementedError`` for an architecture the port's
    ``Transformer`` does not take)."""
    names = [n for n, _ in Transformer(cfg, device="meta").named_parameters()]
    return {n: to_tensor(reference_leaf(tree, n, cfg)) for n in names}


def opt_state_from_reference(opt: Mapping[str, Any],
                             cfg: ModelConfig) -> Dict[str, Any]:
    """Reference AdamW state ``{"m", "v", "step"}`` -> the port's
    (:func:`repro_torch.train.optimizer.adamw_init` layout)."""
    return {"m": params_from_reference(opt["m"], cfg),
            "v": params_from_reference(opt["v"], cfg),
            "step": to_tensor(np.asarray(opt["step"]))}


def reference_path(name: str, cfg: ModelConfig
                   ) -> Tuple[Tuple[str, ...], Optional[int]]:
    """(path of keys into the reference tree, index along its stacked
    ``n_super`` axis or None) of the port parameter ``name``:
    ``layers.{s*P+i}.<group>.<leaf>`` -> (("blocks", "b{i}", group, leaf), s),
    a remainder layer -> (("rem{i}", group, leaf), None), and
    ``embed`` / ``final_norm`` leaves to themselves."""
    parts = tuple(name.split("."))
    if parts[0] != "layers":
        return parts, None
    layer, rest = int(parts[1]), parts[2:]
    P = len(cfg.pattern)
    s, i = divmod(layer, P)
    if s < cfg.n_super:
        return ("blocks", f"b{i}") + rest, s
    return (f"rem{layer - cfg.n_super * P}",) + rest, None


def reference_leaf(tree: Mapping[str, Any], name: str,
                   cfg: ModelConfig) -> np.ndarray:
    """The reference tree's value of the port parameter ``name``."""
    path, index = reference_path(name, cfg)
    a = tree
    for key in path:
        a = a[key]
    a = np.asarray(a)
    return a if index is None else a[index]

"""Load the reference's parameter tree (and AdamW state) into the port.

The reference (``repro.models.transformer.init_params``) keeps a pytree of
nested dicts whose ``blocks.b{i}`` leaves (block ``i`` of the pattern) carry
a leading ``n_super`` axis, and unstacked ``rem{i}`` blocks for the pattern
remainder.  Given that tree as nested dicts of numpy arrays
(``jax.device_get`` of it), this module builds the port's ``state_dict``:
with ``P = len(cfg.pattern)``, port layer ``s*P + i`` takes index ``s`` of
``blocks.b{i}`` and layer ``n_super*P + i`` takes ``rem{i}``; an
encoder-decoder's encoder layer ``j`` takes index ``j`` of ``enc_blocks``
(stacked along ``enc_layers``).  Every other leaf (``embed``,
``final_norm``, ``enc_final_norm``, ``patch_proj``) maps to itself, and
within a block the names are the reference's (``mixer``, ``cross``,
``norm_c``, ``ffn.router`` and the ``(E, ...)`` experts).  bf16 arrays
(an ``ml_dtypes`` dtype) are reinterpreted bit for bit, so this package
never imports ``ml_dtypes``.  :func:`reference_path` gives that map for
one port parameter name, so gradients and updates compare leaf by leaf.
:func:`params_to_reference` goes the other way, and :func:`reference_layout`
gives the reference's tree with the port tensors each of its leaves holds,
which the checkpoint's serialization walks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer


def to_tensor(a: Any) -> torch.Tensor:
    """A numpy array (f32, int, or ml_dtypes bfloat16) as a CPU tensor of
    the same shape (``np.ascontiguousarray`` would make a 0-d array 1-d)."""
    a = np.asarray(a)
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
    axis or None) of the port parameter ``name``:
    ``layers.{s*P+i}.<group>.<leaf>`` -> (("blocks", "b{i}", group, leaf), s),
    a remainder layer -> (("rem{i}", group, leaf), None),
    ``enc_layers.{j}.<group>.<leaf>`` -> (("enc_blocks", group, leaf), j),
    and every other leaf to itself."""
    parts = tuple(name.split("."))
    if parts[0] == "enc_layers":
        return ("enc_blocks",) + parts[2:], int(parts[1])
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


def reference_layout(params: Mapping[str, torch.Tensor], cfg: ModelConfig
                     ) -> Dict[str, Any]:
    """The reference's nested tree for the port parameters ``params`` (a
    ``named_parameters`` mapping, or the moments keyed the same way): a
    stacked leaf holds the list of its port tensors in order (``n_super``
    of them under ``blocks``, ``enc_layers`` under ``enc_blocks``), an
    unstacked leaf its one tensor."""
    tree: Dict[str, Any] = {}
    for name, t in params.items():
        path, index = reference_path(name, cfg)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if index is None:
            node[path[-1]] = t
        else:
            depth = cfg.enc_layers if path[0] == "enc_blocks" else cfg.n_super
            node.setdefault(path[-1], [None] * depth)[index] = t
    return tree


def to_numpy(leaf: Union[torch.Tensor, List[torch.Tensor]]) -> np.ndarray:
    """A host copy of a tensor, or of a list of tensors stacked along a new
    leading axis, that owns its memory; bf16 as its raw ``uint16`` bits."""
    if isinstance(leaf, list):
        t = torch.stack([x.detach() for x in leaf])
    else:
        t = leaf.detach()
        if t.device.type == "cpu":
            t = t.clone()               # .cpu() below would alias the tensor
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def params_to_reference(params: Mapping[str, torch.Tensor],
                        cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of :func:`params_from_reference`: port parameters (or
    moments) -> the reference's nested tree of numpy arrays, bf16 leaves as
    raw ``uint16`` bits."""
    return _to_numpy_tree(reference_layout(params, cfg))


def _to_numpy_tree(node):
    if isinstance(node, dict):
        return {k: _to_numpy_tree(v) for k, v in node.items()}
    return to_numpy(node)

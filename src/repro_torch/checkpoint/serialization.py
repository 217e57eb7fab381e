"""Train state <-> bytes with a layout manifest for elastic restart.

Ported from ``repro.checkpoint.serialization``.  The port's train state
``{"opt": {"m", "step", "v"}, "params": Transformer, "step"}`` holds one
tensor per layer; a checkpoint holds the reference's tree, whose
``blocks/b{i}`` leaves stack the layers along ``n_super``
(:func:`repro_torch.convert.reference_layout`).  Leaves come in jax's
order: dict keys sorted at every level (``"b10" < "b2"``), joined with
:data:`SEP`.  So the leaf list, its order, each leaf's bytes and the
manifest equal the reference's for the same state.  Dtype strings are
numpy's: ``float32``, ``int32``, and ``bfloat16``, whose bytes are the raw
bf16 bits (no ``ml_dtypes``).

Every leaf is flattened to a C-order byte string; the manifest records
``path -> (shape, dtype, row partition)`` where rows are axis-0 slices.
Row-partitioned leaves let a restart with a *different* host count read
exactly the byte ranges it needs (possibly spanning several writers'
shard files) — the manifest is the sharding-layout contract.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import reference_layout, reference_path, to_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer

SEP = "/"

#: manifest dtype string (numpy's name) -> torch dtype
DTYPES = {name: getattr(torch, name) for name in (
    "float32", "bfloat16", "float16", "int32", "int64", "int8", "uint8")}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype, as the manifest records it."""
    name = str(dtype).removeprefix("torch.")
    if name not in DTYPES:
        raise TypeError(f"no checkpoint dtype for {dtype}")
    return name


def _find_cfg(tree) -> Optional[ModelConfig]:
    if isinstance(tree, Transformer):
        return tree.cfg
    if isinstance(tree, Mapping):
        for v in tree.values():
            cfg = _find_cfg(v)
            if cfg is not None:
                return cfg
    return None


def _port_names(node: Mapping) -> bool:
    """A mapping keyed by the port's parameter names (the moments)."""
    return bool(node) and all("." in k for k in node)


def _walk(node, prefix: Tuple[str, ...], cfg: Optional[ModelConfig],
          out: List[Tuple[str, Any]]) -> None:
    if isinstance(node, Transformer):
        node = dict(node.named_parameters())
    if isinstance(node, Mapping):
        if _port_names(node):
            if cfg is None:
                raise ValueError("parameter-named leaves need a Transformer "
                                 "in the same tree")
            node = reference_layout(node, cfg)
        for k in sorted(node):
            _walk(node[k], prefix + (k,), cfg, out)
    else:
        out.append((SEP.join(prefix), node))


def _leaves(tree) -> List[Tuple[str, Any]]:
    """(path, tensor or list of tensors to stack) in jax's order."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, (), _find_cfg(tree), out)
    return out


def _shape_dtype(leaf) -> Tuple[List[int], torch.dtype]:
    if isinstance(leaf, list):
        return [len(leaf)] + list(leaf[0].shape), leaf[0].dtype
    return list(leaf.shape), leaf.dtype


def iter_arrays(tree) -> Iterator[Tuple[str, np.ndarray]]:
    """(path, host array) per leaf, in jax's order, each copied to the host
    only when it is reached; bf16 leaves as their ``uint16`` bits
    (:func:`tree_manifest` names their dtype)."""
    for k, leaf in _leaves(tree):
        yield k, to_numpy(leaf)


def flatten_with_paths(tree) -> List[Tuple[str, np.ndarray]]:
    return list(iter_arrays(tree))


def serialize_tree(tree) -> Dict[str, np.ndarray]:
    return dict(iter_arrays(tree))


def tree_manifest(tree) -> Dict[str, Dict[str, Any]]:
    """path -> {"shape", "dtype"}, read from the tensors without a copy."""
    out = {}
    for k, leaf in _leaves(tree):
        shape, dtype = _shape_dtype(leaf)
        out[k] = {"shape": shape, "dtype": dtype_name(dtype)}
    return out


def deserialize_tree(template, arrays: Dict[str, torch.Tensor]):
    """A new state shaped like ``template`` from named host tensors (in the
    reference's layout, as :meth:`CheckpointManager.restore` reads them).

    Every leaf is a fresh tensor on the template leaf's device, in its dtype;
    a ``Transformer`` is a new module whose parameters take the template's
    ``requires_grad``.  Only the leading ``n_super`` axis is unstacked.  The
    template is not touched."""
    return _build(template, (), arrays, _find_cfg(template))


# Module-level recursion: a recursive closure is a reference cycle, which
# would keep ``arrays`` (a whole host copy of the state) alive until the
# garbage collector next runs.
def _build(node, prefix: Tuple[str, ...], arrays: Dict[str, torch.Tensor],
           cfg: Optional[ModelConfig]):
    if isinstance(node, Transformer):
        model = Transformer(node.cfg, device=node.device)
        old = dict(node.named_parameters())
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(_port_leaf(arrays, prefix, name, cfg).reshape(p.shape))
                p.requires_grad_(old[name].requires_grad)
        return model
    if isinstance(node, Mapping):
        if _port_names(node):
            return {n: _fresh(t, _port_leaf(arrays, prefix, n, cfg))
                    for n, t in node.items()}
        return {k: _build(v, prefix + (k,), arrays, cfg)
                for k, v in node.items()}
    return _fresh(node, arrays[SEP.join(prefix)])


def _port_leaf(arrays: Dict[str, torch.Tensor], prefix: Tuple[str, ...],
               name: str, cfg: ModelConfig) -> torch.Tensor:
    """The host tensor of port parameter ``name`` under ``prefix``."""
    path, index = reference_path(name, cfg)
    a = arrays[SEP.join(prefix + path)]
    return a if index is None else a[index]


def _fresh(like: torch.Tensor, host: torch.Tensor) -> torch.Tensor:
    out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
    return out.copy_(host.reshape(like.shape))


def row_partition(nrows: int, num_hosts: int) -> List[Tuple[int, int]]:
    """Contiguous row ranges per host (first hosts take the remainder)."""
    base, rem = divmod(nrows, num_hosts)
    out, start = [], 0
    for h in range(num_hosts):
        n = base + (1 if h < rem else 0)
        out.append((start, start + n))
        start += n
    return out


def manifest_to_json(manifest: Dict[str, Any]) -> bytes:
    return json.dumps(manifest, sort_keys=True).encode()


def manifest_from_json(data: bytes) -> Dict[str, Any]:
    return json.loads(data.decode())

"""int8 gradient compression with error feedback.

Ported from ``repro.train.grad_compress``: :func:`compress`,
:func:`decompress`, :func:`ef_round` and :func:`ef_init` are pure tensor
math over one gradient leaf, and quantize through
:func:`repro_torch.kernels.ops.quantize` (the CUDA kernel for a CUDA
tensor).  Each leaf is cut into rows of at most 1024 values, each with its
own f32 scale.  :func:`compressed_psum` and :func:`compressed_psum_ef` are
the reference's ``shard_map`` building block over one mesh axis: each rank
quantizes its local tensor, the int8 codes and f32 scales are all-gathered
over the axis, and every rank dequantizes and sums them in rank order, so
two calls give the same bits.  No entry point of the reference calls this
module, and the port's train step does not either.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.sharding import mesh_group


def _rows(x: torch.Tensor) -> torch.Tensor:
    """Reshape any tensor to (rows, <=1024) for row-wise scales, zero-padding
    the last row."""
    flat = x.reshape(-1)
    cols = min(1024, flat.shape[0])
    pad = (-flat.shape[0]) % cols
    return F.pad(flat, (0, pad)).reshape(-1, cols)


def compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return ops.quantize(_rows(x))


def decompress(q: torch.Tensor, s: torch.Tensor, shape,
               dtype: torch.dtype) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    flat = ops.dequantize(q, s).reshape(-1)
    return flat[:n].reshape(shape).to(dtype)


def ef_round(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantization: returns (q, scales, ghat, new_err)."""
    target = g.float() + err.float()
    q, s = compress(target)
    ghat = decompress(q, s, g.shape, torch.float32)
    return q, s, ghat.to(g.dtype), (target - ghat).to(err.dtype)


def ef_init(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """(axis size, *t.shape): every rank's ``t`` in rank order."""
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.reshape((n,) + tuple(t.shape))


def _sum_codes(q: torch.Tensor, s: torch.Tensor, x: torch.Tensor,
               mesh, axis: str) -> torch.Tensor:
    group = mesh_group(mesh, axis)
    qg, sg = _gather(q, group), _gather(s, group)   # (P, rows, cols), (P, rows, 1)
    total = qg[0].float() * sg[0]
    for r in range(1, qg.shape[0]):                 # rank order, fixed
        total = total + qg[r].float() * sg[r]
    return total.reshape(-1)[:x.numel()].reshape(x.shape).to(x.dtype)


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Quantize-allgather-dequantize-sum of this rank's ``x`` over mesh axis
    ``axis``: the sum over the axis's ranks of their decompressed ``x``."""
    q, s = compress(x)
    return _sum_codes(q, s, x, mesh, axis)


def compressed_psum_ef(x: torch.Tensor, err: torch.Tensor, mesh, axis: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback variant: returns (summed, new_err)."""
    target = x.float() + err.float()
    q, s = compress(target)
    ghat = decompress(q, s, x.shape, torch.float32)
    return _sum_codes(q, s, x, mesh, axis), (target - ghat).to(err.dtype)

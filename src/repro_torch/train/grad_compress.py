"""int8 gradient compression with error feedback.

Ported from ``repro.train.grad_compress``: :func:`compress`,
:func:`decompress`, :func:`ef_round` and :func:`ef_init` are pure tensor
math over one gradient leaf, and quantize through
:func:`repro_torch.kernels.ops.quantize` (the CUDA kernel for a CUDA
tensor).  Each leaf is cut into rows of at most 1024 values, each with its
own f32 scale.  The reference's ``compressed_psum`` / ``compressed_psum_ef``
all-gather the codes over a mesh axis; they wait for the distribution
slice.  No entry point of the reference calls this module, and the port's
train step does not either.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


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

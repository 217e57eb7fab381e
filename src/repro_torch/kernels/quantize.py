"""Symmetric per-row int8 quantization: the hand-written CUDA kernel and its
wrapper.

Replaces ``repro.kernels.quantize.quantize_pallas`` (the Pallas TPU kernel
``_quant_kernel``) with ``csrc/quantize.cu``, built with ``nvcc`` for
``sm_90a`` at first use and bound through ctypes.  The plain version of the
same function is :func:`repro_torch.kernels.ref.quantize_ref`; the kernel
gives exactly its codes.  Given a meta tensor it launches nothing: it returns
empty codes and scales and records the kernel's work in
:mod:`repro_torch.kernels.accounting`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import accounting as acc

SOURCE = "quantize.cu"
REPLACES = "src/repro/kernels/quantize.py:35"       # its pl.pallas_call
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process; read and reset by callers that must show
# a path went through the kernel.
LAUNCHES = 0

# C signature of ``repro_quantize_fwd``: x, q, scale; dtype, R, C; stream.
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@functools.cache
def _fn():
    fn = _build.load(SOURCE).repro_quantize_fwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def quantize_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (R,C) f32 or bf16 on a CUDA device.  Returns (int8 codes (R,C),
    f32 scales (R,1)), as ``quantize_pallas``.  Raises on a CPU tensor, an
    unsupported dtype or shape, or a refused launch."""
    global LAUNCHES
    if not (x.is_cuda or x.is_meta):
        raise ValueError(f"quantize_cuda: x is on {x.device}, not a CUDA device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize_cuda: x has dtype {x.dtype}; float32 or "
                        "bfloat16 only")
    if x.dim() != 2:
        raise ValueError(f"quantize_cuda: x must be 2-d (R,C), got shape "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    R, C = x.shape
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    scale = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    if x.is_meta:
        # per element: |x|, a max, a division, a rint, two clamps.
        acc.record("quantize", flops=6 * R * C, special=0,
                   bytes=acc.nbytes(x, q, scale))
        return q, scale
    if x.numel() == 0:
        return q, scale.fill_(1.0)
    fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                 _DTYPES[x.dtype], R, C, stream)
    if err != 0:
        raise RuntimeError(f"quantize_cuda: launch failed with cudaError_t "
                           f"{err} (R={R} C={C})")
    LAUNCHES += 1
    return q, scale

"""Forward flash attention: the hand-written CUDA kernel and its wrapper.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas`` (the
Pallas TPU kernel ``_fa_kernel``) with ``csrc/flash_attention.cu``, built
with ``nvcc`` for ``sm_90a`` at first use and bound through ctypes.  The
plain version of the same function is :func:`repro_torch.kernels.ref.attention_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = "flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:116"   # its pl.pallas_call
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process; read and reset by callers that must show
# a path went through the kernel.
LAUNCHES = 0


# C signature of ``repro_flash_attention_fwd``: q, k, v, o; dtype, B, T, S,
# H, K, D, causal, window; scale; stream.
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p])


@functools.cache
def _fn():
    fn = _build.load(SOURCE).repro_flash_attention_fwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,T,H,D); k,v: (B,S,K,D), all on one CUDA device.  Returns (B,T,H,D).

    Layout and arguments as ``flash_attention_pallas``.  Raises on a CPU
    tensor, an unsupported dtype or shape, or a refused launch.
    """
    global LAUNCHES
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_attention_cuda: {name} is on {x.device}, "
                             "not a CUDA device")
        if x.dtype not in _DTYPES:
            raise TypeError(f"flash_attention_cuda: {name} has dtype {x.dtype}; "
                            "float32 or bfloat16 only")
        if x.dim() != 4 or not x.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be a contiguous "
                             f"4-d tensor, got shape {tuple(x.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention_cuda: q, k, v dtypes differ")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_cuda: q, k, v are on different devices")
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if H % K != 0:
        raise ValueError(f"flash_attention_cuda: H={H} not a multiple of K={K}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda: head dim {D} not in "
                         f"1..{MAX_HEAD_DIM}")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0 or S == 0:
        return out.zero_()
    fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], B, T, S, H, K, D, int(causal), int(window),
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda: launch failed with "
                           f"cudaError_t {err} (B={B} T={T} S={S} H={H} "
                           f"K={K} D={D})")
    LAUNCHES += 1
    return out

"""Mamba1 selective scan: the hand-written CUDA kernel and its wrapper.

Replaces ``repro.kernels.ssm_scan.ssm_scan_pallas`` (the Pallas TPU kernel
``_ssm_kernel``) with ``csrc/ssm_scan.cu``, built with ``nvcc`` for
``sm_90a`` at first use and bound through ctypes.  The kernel scans time in
parallel inside a block: chunks of ``CHUNK`` steps, lanes over segments of
``SEGMENT`` steps, a shuffle scan across them and a carry between chunks.
The plain version of the same function is
:func:`repro_torch.kernels.ref.ssm_scan_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = "ssm_scan.cu"
REPLACES = "src/repro/kernels/ssm_scan.py:79"       # its pl.pallas_call
MAX_STATE = 16
# The kernel's tiles (csrc/ssm_scan.cu states them; tests hold the two
# equal): LANES lanes scan one channel, each over SEGMENT consecutive steps,
# so a chunk is CHUNK = LANES * SEGMENT steps; a block owns CHANNELS
# channels of one batch row, and STAGES chunks are in shared memory at once.
SEGMENT = 16
LANES = 4
CHANNELS = 64
CHUNK = LANES * SEGMENT
STAGES = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches in this process; read and reset by callers that must show
# a path went through the kernel.
LAUNCHES = 0

# C signature of ``repro_ssm_scan_fwd``: x, dt, A, B, C, D, h0, y, hT;
# dtype, Bt, T, I, N; stream.
ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@functools.cache
def _fn():
    fn = _build.load(SOURCE).repro_ssm_scan_fwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _f32(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    """``t`` as a contiguous f32 tensor of ``shape`` on ``device``; an
    upcast from bf16 is exact."""
    if not t.is_cuda:
        raise ValueError(f"ssm_scan_cuda: {name} is on {t.device}, not a "
                         "CUDA device")
    if t.device != device:
        raise ValueError(f"ssm_scan_cuda: {name} is on {t.device}, x on {device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"ssm_scan_cuda: {name} has dtype {t.dtype}; "
                        "float32 or bfloat16 only")
    if tuple(t.shape) != shape:
        raise ValueError(f"ssm_scan_cuda: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    return t.float().contiguous()


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (Bt,T,I); A: (I,N); B, C: (Bt,T,N); D: (I,); h0: (Bt,I,N) or
    None, all on one CUDA device.  Returns (y (Bt,T,I) in x's dtype, h_T
    (Bt,I,N) f32), as ``ssm_scan_ref``.

    x must be contiguous f32 or bf16; the other inputs are taken in f32
    (bf16 ones are upcast exactly).  Raises on a CPU tensor, an unsupported
    dtype or shape, or a refused launch.
    """
    global LAUNCHES
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, D, h0)):
        raise NotImplementedError(
            "ssm_scan_cuda: backward not yet ported, and the kernel's result "
            "would carry no graph; train this architecture on the CPU "
            "(plain autograd) or call the kernel under torch.no_grad()")
    if not x.is_cuda:
        raise ValueError(f"ssm_scan_cuda: x is on {x.device}, not a CUDA device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssm_scan_cuda: x has dtype {x.dtype}; float32 or "
                        "bfloat16 only")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"ssm_scan_cuda: x must be a contiguous 3-d tensor, "
                         f"got shape {tuple(x.shape)}")
    if A.dim() != 2:
        raise ValueError(f"ssm_scan_cuda: A must be (I,N), got {tuple(A.shape)}")
    Bt, T, I = x.shape
    N = A.shape[1]
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"ssm_scan_cuda: state size {N} not in 1..{MAX_STATE}")
    dev = x.device
    dt = _f32("dt", dt, (Bt, T, I), dev)
    A = _f32("A", A, (I, N), dev)
    B = _f32("B", B, (Bt, T, N), dev)
    C = _f32("C", C, (Bt, T, N), dev)
    D = _f32("D", D, (I,), dev)
    if h0 is not None:
        h0 = _f32("h0", h0, (Bt, I, N), dev)
    y = torch.empty_like(x)
    hT = torch.empty((Bt, I, N), dtype=torch.float32, device=dev)
    if x.numel() == 0:                   # no step: h_T is the initial state
        return y, (hT.copy_(h0) if h0 is not None else hT.zero_())
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), D.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 hT.data_ptr(), _DTYPES[x.dtype], Bt, T, I, N, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_cuda: launch failed with cudaError_t "
                           f"{err} (Bt={Bt} T={T} I={I} N={N})")
    LAUNCHES += 1
    return y, hT

"""RG-LRU recurrence: the hand-written CUDA kernel and its wrapper.

Replaces ``repro.kernels.rglru_scan.rglru_pallas`` (the Pallas TPU kernel
``_rglru_kernel``) with ``csrc/rglru_scan.cu``, built with ``nvcc`` for
``sm_90a`` at first use and bound through ctypes.  The kernel scans time in
parallel inside a block: chunks of ``CHUNK`` steps, lanes over segments of
``SEGMENT`` steps, a shuffle scan across them and a carry between chunks.
The plain version of the same function is
:func:`repro_torch.kernels.ref.rglru_ref`.  Unlike the
Pallas wrapper, which pads T without masking, the kernel walks exactly T
steps, so ``h_T`` is right for every T.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = "rglru_scan.cu"
REPLACES = "src/repro/kernels/rglru_scan.py:73"     # its pl.pallas_call
# The kernel's tiles (csrc/rglru_scan.cu states them; tests hold the two
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

# C signature of ``repro_rglru_scan_fwd``: x, a_gate, i_gate, log_lam, h0,
# y, hT; dtype, B, T, L; c; stream.
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p])


@functools.cache
def _fn():
    fn = _build.load(SOURCE).repro_rglru_scan_fwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def rglru_scan_cuda(x: torch.Tensor, a_gate: torch.Tensor,
                    i_gate: torch.Tensor, log_lam: torch.Tensor,
                    h0: Optional[torch.Tensor] = None, c: float = 8.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, a_gate, i_gate: (B,T,L), contiguous, one dtype (f32 or bf16);
    log_lam: (L,); h0: (B,L) or None; all on one CUDA device.  Returns (h
    sequence (B,T,L) in x's dtype, h_T (B,L) f32), as ``rglru_ref``.

    log_lam and h0 are taken in f32.  Raises on a CPU tensor, an unsupported
    dtype or shape, or a refused launch.
    """
    global LAUNCHES
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, a_gate, i_gate, log_lam, h0)):
        raise NotImplementedError(
            "rglru_scan_cuda: backward not yet ported, and the kernel's result "
            "would carry no graph; train this architecture on the CPU "
            "(plain autograd) or call the kernel under torch.no_grad()")
    for name, t in (("x", x), ("a_gate", a_gate), ("i_gate", i_gate),
                    ("log_lam", log_lam)) + ((("h0", h0),) if h0 is not None else ()):
        if not t.is_cuda:
            raise ValueError(f"rglru_scan_cuda: {name} is on {t.device}, not "
                             "a CUDA device")
        if t.device != x.device:
            raise ValueError(f"rglru_scan_cuda: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"rglru_scan_cuda: {name} has dtype {t.dtype}; "
                            "float32 or bfloat16 only")
    if x.dim() != 3:
        raise ValueError(f"rglru_scan_cuda: x must be (B,T,L), got "
                         f"{tuple(x.shape)}")
    B, T, L = x.shape
    for name, t in (("a_gate", a_gate), ("i_gate", i_gate)):
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"rglru_scan_cuda: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, x is {x.dtype} {tuple(x.shape)}")
    if not (x.is_contiguous() and a_gate.is_contiguous()
            and i_gate.is_contiguous()):
        raise ValueError("rglru_scan_cuda: x, a_gate, i_gate must be contiguous")
    if tuple(log_lam.shape) != (L,):
        raise ValueError(f"rglru_scan_cuda: log_lam has shape "
                         f"{tuple(log_lam.shape)}, expected ({L},)")
    log_lam = log_lam.float().contiguous()
    if h0 is not None:
        if tuple(h0.shape) != (B, L):
            raise ValueError(f"rglru_scan_cuda: h0 has shape {tuple(h0.shape)}, "
                             f"expected ({B}, {L})")
        h0 = h0.float().contiguous()
    y = torch.empty_like(x)
    hT = torch.empty((B, L), dtype=torch.float32, device=x.device)
    if x.numel() == 0:                   # no step: h_T is the initial state
        return y, (hT.copy_(h0) if h0 is not None else hT.zero_())
    fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), a_gate.data_ptr(), i_gate.data_ptr(),
                 log_lam.data_ptr(), None if h0 is None else h0.data_ptr(),
                 y.data_ptr(), hT.data_ptr(), _DTYPES[x.dtype], B, T, L,
                 float(c), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_cuda: launch failed with cudaError_t "
                           f"{err} (B={B} T={T} L={L})")
    LAUNCHES += 1
    return y, hT

"""RG-LRU recurrence: the hand-written CUDA kernels, forward and backward,
and their wrapper.

Replaces ``repro.kernels.rglru_scan.rglru_pallas`` (the Pallas TPU kernel
``_rglru_kernel``) with ``csrc/rglru_scan.cu``, built with ``nvcc`` for
``sm_90a`` at first use and bound through ctypes.  The kernel scans time in
parallel inside a block: chunks of ``CHUNK`` steps, lanes over segments of
``SEGMENT`` steps, a shuffle scan across them and a carry between chunks.
The Pallas kernel has no backward (the reference differentiates its chunked
jnp scan, ``repro.kernels.ops.rglru``, with ``jax.grad``); here the gradient
is ``csrc/rglru_scan_bwd.cu``, the same chunks walked in reverse from the
f32 states the forward saves at each chunk's start (in shorter segments,
over more lanes), joined to the forward by a ``torch.autograd.Function``.
The plain version of the same function is
:func:`repro_torch.kernels.ref.rglru_ref`, and of its gradient autograd
through it.  Unlike the Pallas wrapper, which pads T without masking, the
kernels walk exactly T steps, so ``h_T`` is right for every T.  Given meta
tensors, forward and backward launch nothing: they return empty outputs of
the kernels' shapes and dtypes (h_T and the chunk carries f32) and record
the kernels' work in :mod:`repro_torch.kernels.accounting`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import accounting as acc

SOURCE = "rglru_scan.cu"
BWD_SOURCE = "rglru_scan_bwd.cu"
REPLACES = "src/repro/kernels/rglru_scan.py:73"     # its pl.pallas_call
# The forward kernel's tiles (csrc/rglru_scan.cu states them; tests hold the
# two equal): LANES lanes scan one channel, each over SEGMENT consecutive
# steps, so a chunk is CHUNK = LANES * SEGMENT steps; a block owns CHANNELS
# channels of one batch row, and STAGES chunks are in shared memory at once.
SEGMENT = 16
LANES = 4
CHANNELS = 64
CHUNK = LANES * SEGMENT
STAGES = 2
# The backward kernel's own tiles (csrc/rglru_scan_bwd.cu states them): the
# forward's chunks of CHUNK steps cut into BWD_LANES segments of BWD_SEGMENT
# steps, BWD_CHANNELS channels a block, BWD_STAGES chunks in shared memory.
BWD_SEGMENT = 4
BWD_LANES = 16
BWD_CHANNELS = 32
BWD_STAGES = 3
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the forward and of the backward kernel in this process; read
# and reset by callers that must show a path went through the kernels.
LAUNCHES = 0
BWD_LAUNCHES = 0

# C signature of ``repro_rglru_scan_fwd``: x, a_gate, i_gate, log_lam, h0,
# y, hT, carries; dtype, B, T, L; c; stream.
ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p])
# C signature of ``repro_rglru_scan_bwd``: x, a_gate, i_gate, log_lam,
# carries, dh, dhT, dx, da_gate, di_gate, dlog_lam, dh0, scratch; dtype, B,
# T, L; c; stream.
BWD_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_void_p])


@functools.cache
def _fn():
    fn = _build.load(SOURCE).repro_rglru_scan_fwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    fn = _build.load(BWD_SOURCE).repro_rglru_scan_bwd
    fn.argtypes = BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _prepare(x, a_gate, i_gate, log_lam, h0):
    """The inputs checked and as the kernels take them: x and the gates as
    given (one dtype, contiguous), log_lam and h0 f32 and contiguous."""
    for name, t in (("x", x), ("a_gate", a_gate), ("i_gate", i_gate),
                    ("log_lam", log_lam)) + ((("h0", h0),) if h0 is not None else ()):
        if not (t.is_cuda or t.is_meta):
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
    if h0 is not None:
        if tuple(h0.shape) != (B, L):
            raise ValueError(f"rglru_scan_cuda: h0 has shape {tuple(h0.shape)}, "
                             f"expected ({B}, {L})")
        h0 = h0.detach().float().contiguous()
    return (x.detach(), a_gate.detach(), i_gate.detach(),
            log_lam.detach().float().contiguous(), h0)


def rglru_scan_cuda(x: torch.Tensor, a_gate: torch.Tensor,
                    i_gate: torch.Tensor, log_lam: torch.Tensor,
                    h0: Optional[torch.Tensor] = None, c: float = 8.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, a_gate, i_gate: (B,T,L), contiguous, one dtype (f32 or bf16);
    log_lam: (L,); h0: (B,L) or None; all on one CUDA device.  Returns (h
    sequence (B,T,L) in x's dtype, h_T (B,L) f32), as ``rglru_ref``.

    log_lam and h0 are taken in f32.  When grad is enabled and an input
    requires it, the result carries a graph whose backward is the CUDA
    backward kernel, and the forward also saves the state entering each
    chunk for it.  Raises on a CPU tensor, an unsupported dtype or shape,
    or a refused launch.  On meta tensors it launches nothing and records
    the work (module docstring).
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, a_gate, i_gate, log_lam, h0)):
        return _RGLRUScan.apply(x, a_gate, i_gate, log_lam, h0, float(c))
    hs, hT, _ = _forward(*_prepare(x, a_gate, i_gate, log_lam, h0), c,
                         save=False)
    return hs, hT


def _forward(x, a_gate, i_gate, log_lam, h0, c: float, save: bool):
    """The forward kernel on prepared inputs: (h sequence, h_T, carries),
    carries (B, ceil(T/CHUNK), L) f32 with ``save``, else None."""
    global LAUNCHES
    B, T, L = x.shape
    y = torch.empty_like(x)
    hT = torch.empty((B, L), dtype=torch.float32, device=x.device)
    carries = (torch.empty((B, -(-T // CHUNK), L), dtype=torch.float32,
                           device=x.device) if save else None)
    if x.is_meta:
        # per element: 7 special-function ops and about 12 flops.
        acc.record("rglru_scan", flops=B * T * L * 12, special=B * T * L * 7,
                   bytes=acc.nbytes(x, a_gate, i_gate, log_lam, h0, y, hT,
                                    carries))
        return y, hT, carries
    if x.numel() == 0:                   # no step: h_T is the initial state
        return y, (hT.copy_(h0) if h0 is not None else hT.zero_()), carries
    fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), a_gate.data_ptr(), i_gate.data_ptr(),
                 log_lam.data_ptr(), None if h0 is None else h0.data_ptr(),
                 y.data_ptr(), hT.data_ptr(),
                 None if carries is None else carries.data_ptr(),
                 _DTYPES[x.dtype], B, T, L, float(c), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_cuda: launch failed with cudaError_t "
                           f"{err} (B={B} T={T} L={L})")
    LAUNCHES += 1
    return y, hT, carries


def rglru_scan_bwd_cuda(dh: torch.Tensor, dhT: Optional[torch.Tensor],
                        x: torch.Tensor, a_gate: torch.Tensor,
                        i_gate: torch.Tensor, log_lam: torch.Tensor,
                        carries: torch.Tensor, c: float = 8.0):
    """Gradients (dx, da_gate, di_gate, dlog_lam, dh0) of
    ``rglru_scan_cuda``'s (h sequence, h_T) given dh (B,T,L) and dhT (B,L)
    or None, from the forward's prepared inputs and the ``carries`` it
    saved.  dx and the gate gradients have x's dtype, dlog_lam and dh0 are
    f32.  Raises on a refused launch."""
    global BWD_LAUNCHES
    B, T, L = x.shape
    dev = x.device
    if dh.device != dev or (dhT is not None and dhT.device != dev):
        raise ValueError(f"rglru_scan_bwd_cuda: dh on {dh.device}, x on {dev}")
    dh = dh.to(x.dtype).contiguous()
    if dhT is not None:
        if tuple(dhT.shape) != (B, L):
            raise ValueError(f"rglru_scan_bwd_cuda: dhT has shape "
                             f"{tuple(dhT.shape)}, expected ({B}, {L})")
        dhT = dhT.float().contiguous()
    if carries.shape != (B, -(-T // CHUNK), L) or carries.dtype != torch.float32:
        raise ValueError(f"rglru_scan_bwd_cuda: carries {tuple(carries.shape)} "
                         f"{carries.dtype}, expected ({B}, {-(-T // CHUNK)}, "
                         f"{L}) float32")
    f32 = dict(dtype=torch.float32, device=dev)
    dx, dag, dig = (torch.empty_like(x) for _ in range(3))
    dlam, dh0 = torch.empty((L,), **f32), torch.empty((B, L), **f32)
    if x.is_meta:
        # per element: 8 special-function ops and about 30 flops.
        acc.record("rglru_scan_bwd", flops=B * T * L * 30, special=B * T * L * 8,
                   bytes=acc.nbytes(x, a_gate, i_gate, log_lam, carries, dh,
                                    dhT, dx, dag, dig, dlam, dh0))
        return dx, dag, dig, dlam, dh0
    if x.numel() == 0:                   # no step: dh0 is dh_T
        return (dx, dag, dig, dlam.zero_(),
                dhT.clone() if dhT is not None else dh0.zero_())
    scratch = torch.empty((B, L), **f32)
    fn = _bwd_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), a_gate.data_ptr(), i_gate.data_ptr(),
                 log_lam.data_ptr(), carries.data_ptr(), dh.data_ptr(),
                 None if dhT is None else dhT.data_ptr(), dx.data_ptr(),
                 dag.data_ptr(), dig.data_ptr(), dlam.data_ptr(),
                 dh0.data_ptr(), scratch.data_ptr(), _DTYPES[x.dtype], B, T,
                 L, float(c), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd_cuda: launch failed with "
                           f"cudaError_t {err} (B={B} T={T} L={L})")
    BWD_LAUNCHES += 1
    return dx, dag, dig, dlam, dh0


class _RGLRUScan(torch.autograd.Function):
    """The forward kernel, saving its prepared inputs and the chunk
    carries; its backward is the backward kernel."""

    @staticmethod
    def forward(ctx, x, a_gate, i_gate, log_lam, h0, c):
        args = _prepare(x, a_gate, i_gate, log_lam, h0)
        hs, hT, carries = _forward(*args, c, save=True)
        ctx.save_for_backward(*args[:4], carries)
        ctx.c = c
        ctx.dtypes = tuple(None if t is None else t.dtype
                           for t in (x, a_gate, i_gate, log_lam, h0))
        ctx.set_materialize_grads(False)
        return hs, hT

    @staticmethod
    def backward(ctx, dh, dhT):
        x, a_gate, i_gate, log_lam, carries = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(x)
        grads = rglru_scan_bwd_cuda(dh, dhT, x, a_gate, i_gate, log_lam,
                                    carries, ctx.c)
        return tuple(None if dtype is None else g.to(dtype)
                     for g, dtype in zip(grads, ctx.dtypes)) + (None,)

"""Mamba1 selective scan: the hand-written CUDA kernels, forward and
backward, and their wrapper.

Replaces ``repro.kernels.ssm_scan.ssm_scan_pallas`` (the Pallas TPU kernel
``_ssm_kernel``) with ``csrc/ssm_scan.cu``, built with ``nvcc`` for
``sm_90a`` at first use and bound through ctypes.  The kernel scans time in
parallel inside a block: chunks of ``CHUNK`` steps, lanes over segments of
``SEGMENT`` steps, a shuffle scan across them and a carry between chunks.
The Pallas kernel has no backward (the reference differentiates its chunked
jnp scan, ``repro.kernels.ops.ssm_scan``, with ``jax.grad``); here the
gradient is ``csrc/ssm_scan_bwd.cu``, the same chunks walked in reverse from
the states the forward saves at each chunk's start (in shorter segments,
over more lanes, with the states in pairs), joined to the forward by a
``torch.autograd.Function``.  The plain version of the same function is
:func:`repro_torch.kernels.ref.ssm_scan_ref`, and of its gradient autograd
through it.  Given meta tensors, forward and backward launch nothing: they
return empty outputs of the kernels' shapes and dtypes (h_T and the chunk
carries f32) and record the kernels' work in
:mod:`repro_torch.kernels.accounting`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import accounting as acc

SOURCE = "ssm_scan.cu"
BWD_SOURCE = "ssm_scan_bwd.cu"
REPLACES = "src/repro/kernels/ssm_scan.py:79"       # its pl.pallas_call
MAX_STATE = 16
# The forward kernel's tiles (csrc/ssm_scan.cu states them; tests hold the
# two equal): LANES lanes scan one channel, each over SEGMENT consecutive
# steps, so a chunk is CHUNK = LANES * SEGMENT steps; a block owns CHANNELS
# channels of one batch row, and STAGES chunks are in shared memory at once.
SEGMENT = 16
LANES = 4
CHANNELS = 64
CHUNK = LANES * SEGMENT
STAGES = 2
# The backward kernel's own tiles (csrc/ssm_scan_bwd.cu states them): the
# forward's chunks of CHUNK steps cut into BWD_LANES segments of BWD_SEGMENT
# steps, BWD_CHANNELS channels a block, BWD_STAGES chunks in shared memory,
# and the states taken BWD_GROUP at a time.
BWD_SEGMENT = 8
BWD_LANES = 8
BWD_CHANNELS = 64
BWD_STAGES = 2
BWD_GROUP = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the forward and of the backward kernel in this process; read
# and reset by callers that must show a path went through the kernels.
LAUNCHES = 0
BWD_LAUNCHES = 0

# C signature of ``repro_ssm_scan_fwd``: x, dt, A, B, C, D, h0, y, hT,
# carries; dtype, Bt, T, I, N; stream.
ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# C signature of ``repro_ssm_scan_bwd``: x, dt, A, B, C, D, carries, dy,
# dhT, dx, ddt, dA, dB, dC, dD, dh0, scratch; dtype, Bt, T, I, N; stream.
BWD_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# ``repro_ssm_scan_bwd_scratch``: Bt, T, I, N -> floats of scratch.
SCRATCH_ARGTYPES = [ctypes.c_int] * 4


@functools.cache
def _fn():
    fn = _build.load(SOURCE).repro_ssm_scan_fwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fns():
    lib = _build.load(BWD_SOURCE)
    fn, scratch = lib.repro_ssm_scan_bwd, lib.repro_ssm_scan_bwd_scratch
    fn.argtypes, fn.restype = BWD_ARGTYPES, ctypes.c_int
    scratch.argtypes, scratch.restype = SCRATCH_ARGTYPES, ctypes.c_long
    return fn, scratch


def _f32(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    """``t`` as a contiguous f32 tensor of ``shape`` on ``device``; an
    upcast from bf16 is exact."""
    if not (t.is_cuda or t.is_meta):
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
    return t.detach().float().contiguous()


def _prepare(x, dt, A, B, C, D, h0):
    """The inputs checked and as the kernels take them: x as given (f32 or
    bf16, contiguous), every other tensor f32 and contiguous."""
    if not (x.is_cuda or x.is_meta):
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
    return (x.detach(), _f32("dt", dt, (Bt, T, I), dev),
            _f32("A", A, (I, N), dev), _f32("B", B, (Bt, T, N), dev),
            _f32("C", C, (Bt, T, N), dev), _f32("D", D, (I,), dev),
            None if h0 is None else _f32("h0", h0, (Bt, I, N), dev))


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (Bt,T,I); A: (I,N); B, C: (Bt,T,N); D: (I,); h0: (Bt,I,N) or
    None, all on one CUDA device.  Returns (y (Bt,T,I) in x's dtype, h_T
    (Bt,I,N) f32), as ``ssm_scan_ref``.

    x must be contiguous f32 or bf16; the other inputs are taken in f32
    (bf16 ones are upcast exactly).  When grad is enabled and an input
    requires it, the result carries a graph whose backward is the CUDA
    backward kernel, and the forward also saves the state entering each
    chunk for it.  Raises on a CPU tensor, an unsupported dtype or shape,
    or a refused launch.  On meta tensors it launches nothing and records
    the work (module docstring).
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, D, h0)):
        return _SSMScan.apply(x, dt, A, B, C, D, h0)
    y, hT, _ = _forward(*_prepare(x, dt, A, B, C, D, h0), save=False)
    return y, hT


def _forward(x, dt, A, B, C, D, h0, save: bool):
    """The forward kernel on prepared inputs: (y, h_T, carries), carries
    (Bt, ceil(T/CHUNK), I, N) f32 with ``save``, else None."""
    global LAUNCHES
    Bt, T, I = x.shape
    N = A.shape[1]
    dev = x.device
    y = torch.empty_like(x)
    hT = torch.empty((Bt, I, N), dtype=torch.float32, device=dev)
    carries = (torch.empty((Bt, -(-T // CHUNK), I, N), dtype=torch.float32,
                           device=dev) if save else None)
    if x.is_meta:
        # per (b,t,i,n): 6 flops and one exp; per (b,t,i): 3 flops.
        acc.record("ssm_scan", flops=Bt * T * I * (6 * N + 3),
                   special=Bt * T * I * N,
                   bytes=acc.nbytes(x, dt, A, B, C, D, h0, y, hT, carries))
        return y, hT, carries
    if x.numel() == 0:                   # no step: h_T is the initial state
        return y, (hT.copy_(h0) if h0 is not None else hT.zero_()), carries
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), D.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 hT.data_ptr(), None if carries is None else carries.data_ptr(),
                 _DTYPES[x.dtype], Bt, T, I, N, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_cuda: launch failed with cudaError_t "
                           f"{err} (Bt={Bt} T={T} I={I} N={N})")
    LAUNCHES += 1
    return y, hT, carries


def ssm_scan_bwd_cuda(dy: torch.Tensor, dhT: Optional[torch.Tensor],
                      x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                      carries: torch.Tensor):
    """Gradients (dx, ddt, dA, dB, dC, dD, dh0) of ``ssm_scan_cuda``'s
    (y, h_T) given dy (Bt,T,I) and dhT (Bt,I,N) or None, from the forward's
    prepared inputs and the ``carries`` it saved.  dx has x's dtype, the
    rest are f32.  Raises on a refused launch."""
    global BWD_LAUNCHES
    Bt, T, I = x.shape
    N = A.shape[1]
    dev = x.device
    if dy.device != dev or (dhT is not None and dhT.device != dev):
        raise ValueError(f"ssm_scan_bwd_cuda: dy on {dy.device}, x on {dev}")
    dy = dy.to(x.dtype).contiguous()
    dhT = None if dhT is None else _f32("dhT", dhT, (Bt, I, N), dev)
    if carries.shape != (Bt, -(-T // CHUNK), I, N) or carries.dtype != torch.float32:
        raise ValueError(f"ssm_scan_bwd_cuda: carries {tuple(carries.shape)} "
                         f"{carries.dtype}, expected ({Bt}, {-(-T // CHUNK)}, "
                         f"{I}, {N}) float32")
    f32 = dict(dtype=torch.float32, device=dev)
    dx, ddt = torch.empty_like(x), torch.empty((Bt, T, I), **f32)
    dA, dD = torch.empty((I, N), **f32), torch.empty((I,), **f32)
    dB, dC = torch.empty((Bt, T, N), **f32), torch.empty((Bt, T, N), **f32)
    dh0 = torch.empty((Bt, I, N), **f32)
    if x.is_meta:
        # per (b,t,i,n): 20 flops and one exp.
        acc.record("ssm_scan_bwd", flops=Bt * T * I * N * 20,
                   special=Bt * T * I * N,
                   bytes=acc.nbytes(x, dt, A, B, C, D, carries, dy, dhT, dx,
                                    ddt, dA, dB, dC, dD, dh0))
        return dx, ddt, dA, dB, dC, dD, dh0
    if x.numel() == 0:                   # no step: dh0 is dh_T
        return (dx, ddt, dA.zero_(), dB, dC, dD.zero_(),
                dhT.clone() if dhT is not None else dh0.zero_())
    fn, scratch_floats = _bwd_fns()
    scratch = torch.empty(scratch_floats(Bt, T, I, N), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), D.data_ptr(), carries.data_ptr(), dy.data_ptr(),
                 None if dhT is None else dhT.data_ptr(), dx.data_ptr(),
                 ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                 dD.data_ptr(), dh0.data_ptr(), scratch.data_ptr(),
                 _DTYPES[x.dtype], Bt, T, I, N, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan_bwd_cuda: launch failed with "
                           f"cudaError_t {err} (Bt={Bt} T={T} I={I} N={N})")
    BWD_LAUNCHES += 1
    return dx, ddt, dA, dB, dC, dD, dh0


class _SSMScan(torch.autograd.Function):
    """The forward kernel, saving its prepared inputs and the chunk
    carries; its backward is the backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0):
        args = _prepare(x, dt, A, B, C, D, h0)
        y, hT, carries = _forward(*args, save=True)
        ctx.save_for_backward(*args[:6], carries)
        ctx.dtypes = tuple(None if t is None else t.dtype
                           for t in (x, dt, A, B, C, D, h0))
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, A, B, C, D, carries = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssm_scan_bwd_cuda(dy, dhT, x, dt, A, B, C, D, carries)
        return tuple(None if dtype is None else g.to(dtype)
                     for g, dtype in zip(grads, ctx.dtypes))

"""Flash attention: the hand-written CUDA kernels, forward and backward, and
their wrapper.

Replaces ``repro.kernels.flash_attention.flash_attention_pallas`` (the
Pallas TPU kernel ``_fa_kernel``) with ``csrc/flash_attention.cu``, built
with ``nvcc`` for ``sm_90a`` at first use and bound through ctypes.  The
Pallas kernel has no backward (the reference trains through its chunked jnp
attention and lets JAX differentiate it); here the gradient is
``csrc/flash_attention_bwd.cu``, joined to the forward by a
``torch.autograd.Function``.  The plain version of the same function is
:func:`repro_torch.kernels.ref.attention_ref`, and of its gradient autograd
through it.  Given meta tensors, forward and backward launch nothing: they
return empty outputs of the kernels' shapes and dtypes and record the
kernels' work in :mod:`repro_torch.kernels.accounting`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import accounting as acc

SOURCE = "flash_attention.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
REPLACES = "src/repro/kernels/flash_attention.py:116"   # its pl.pallas_call
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the forward and of the backward kernels in this process; read
# and reset by callers that must show a path went through the kernels.
LAUNCHES = 0
BWD_LAUNCHES = 0


# C signature of ``repro_flash_attention_fwd``: q, k, v, o, lse, o_lo; dtype,
# B, T, S, H, K, D, causal, window; scale; stream.
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p])
# C signature of ``repro_flash_attention_bwd``: q, k, v, o, o_lo, dout, lse,
# delta, partial, dq, dk, dv; dtype, B, T, S, H, K, D, groups, causal,
# window; scale; stream.
BWD_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
                + [ctypes.c_float, ctypes.c_void_p])
# ``repro_flash_attention_fwd_path`` / ``_bwd_path``: dtype, D, aligned.
PATH_ARGTYPES = [ctypes.c_int] * 3
# ``repro_flash_attention_bwd_groups``: B, S, H, K, D.
GROUPS_ARGTYPES = [ctypes.c_int] * 5
# What the path queries return: the forward and the backward take 2 for
# bf16 at head dims 64, 128 and 256, 1 for bf16 at 16 and 32.
PATHS = {0: "fma", 1: "tensor cores", 2: "wgmma"}
# Tiles of the forward's wgmma kernel (namespace wg of ``SOURCE``), by head
# dim: query rows a block, keys a KV tile, KV tiles in the ring.
WGMMA_TILES = {64: (128, 128, 3), 128: (128, 128, 2), 256: (128, 64, 2)}
# Tiles of the backward's wgmma kernels (namespace wgb of ``BWD_SOURCE``),
# by head dim: dK/dV query rows a stage, keys a block, stages in the ring;
# dQ query rows a block, keys a stage, stages in the ring (at 256 slots of
# one K or V tile each).
WGMMA_BWD_TILES = {64: (128, 128, 2, 128, 128, 2), 128: (64, 128, 2, 128, 128, 2),
                   256: (64, 64, 2, 128, 64, 3)}
# Keys a KV tile of the forward's mma.sync kernel (``tc::BK``).
MMA_TILE_KEYS = 32


@functools.cache
def _fn():
    fn = _build.load(SOURCE).repro_flash_attention_fwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    fn = _build.load(BWD_SOURCE).repro_flash_attention_bwd
    fn.argtypes = BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _query(source: str, symbol: str, argtypes: tuple):
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def fwd_path(dtype: torch.dtype, head_dim: int, aligned: bool = True) -> int:
    """The forward kernel a call takes (a key of ``PATHS``), as the CUDA
    dispatch decides it.  Builds the kernel on first use."""
    return _query(SOURCE, "repro_flash_attention_fwd_path",
                  tuple(PATH_ARGTYPES))(_DTYPES[dtype], head_dim, int(aligned))


def bwd_path(dtype: torch.dtype, head_dim: int, aligned: bool = True) -> int:
    """The backward kernels a call takes (a key of ``PATHS``)."""
    return _query(BWD_SOURCE, "repro_flash_attention_bwd_path",
                  tuple(PATH_ARGTYPES))(_DTYPES[dtype], head_dim, int(aligned))


def bwd_groups(B: int, S: int, H: int, K: int, D: int) -> int:
    """How many groups the tensor-core backward at head dim D splits each
    KV head's H/K query heads into at this shape."""
    return _query(BWD_SOURCE, "repro_flash_attention_bwd_groups",
                  tuple(GROUPS_ARGTYPES))(B, S, H, K, D)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in tensors)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,T,H,D); k,v: (B,S,K,D), all on one CUDA device.  Returns (B,T,H,D).

    Layout and arguments as ``flash_attention_pallas``.  When grad is
    enabled and an input requires it, the result carries a graph whose
    backward is the CUDA backward kernel.  Raises on a CPU tensor, an
    unsupported dtype or shape, or a refused launch.  On meta tensors it
    launches nothing and records the work (module docstring).
    """
    _check(q, k, v)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                     float(scale))
    return _forward(q, k, v, causal, window, scale, with_lse=False)[0]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not (x.is_cuda or x.is_meta):
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


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             window: int, scale: float, with_lse: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                        Optional[torch.Tensor]]:
    """The forward kernel on checked inputs: (o, lse, o_lo).  With
    ``with_lse``, lse is (B,H,T) f32 and, for bf16, o_lo is what rounding
    the f32 output to o lost, for the backward's Delta; else both None."""
    global LAUNCHES
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    o_lo = torch.empty_like(q) if with_lse and q.dtype != torch.float32 else None
    if q.is_meta:
        pairs = B * H * acc.visible_pairs(T, S, causal, window)
        acc.record("flash_attention", flops=4 * D * pairs, special=pairs,
                   bytes=acc.nbytes(q, k, v, out, lse, o_lo),
                   dense_flops=4 * D * B * H * T * S)
        return out, lse, o_lo
    if out.numel() == 0 or S == 0:
        return (out.zero_(), None if lse is None else lse.fill_(float("-inf")),
                None if o_lo is None else o_lo.zero_())
    fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 None if o_lo is None else o_lo.data_ptr(),
                 _DTYPES[q.dtype], B, T, S, H, K, D, int(causal), int(window),
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda: launch failed with "
                           f"cudaError_t {err} (B={B} T={T} S={S} H={H} "
                           f"K={K} D={D})")
    LAUNCHES += 1
    return out, lse, o_lo


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             scale: Optional[float] = None,
                             o_lo: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of the forward's output ``o`` given ``dout``
    (B,T,H,D) and the forward's log-sum-exp ``lse`` (B,H,T) f32; ``o_lo``
    is the forward's rounding residual of ``o`` (``_forward``), without
    which Delta = rowsum(dO * O) sees O only to bf16.  Inputs as
    :func:`flash_attention_cuda`; the gradients have their inputs' dtypes.
    Raises on a CPU tensor, a mismatched shape or dtype, or a refused
    launch."""
    global BWD_LAUNCHES
    _check(q, k, v)
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    given = [("o", o), ("dout", dout)] + ([] if o_lo is None else [("o_lo", o_lo)])
    for name, x in given:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_bwd_cuda: {name} is "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}, "
                             f"q is {tuple(q.shape)} {q.dtype} on {q.device}")
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd_cuda: lse is {tuple(lse.shape)} "
                         f"{lse.dtype}, expected ({B}, {H}, {T}) float32")
    scale = scale if scale is not None else D ** -0.5
    o, dout, lse = o.contiguous(), dout.contiguous(), lse.contiguous()
    o_lo = None if o_lo is None else o_lo.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.is_meta:
        # Five products of 2*D flops per visible pair (S, dP, dV, dQ, dK).
        pairs = B * H * acc.visible_pairs(T, S, causal, window)
        acc.record("flash_attention_bwd", flops=10 * D * pairs, special=pairs,
                   bytes=acc.nbytes(q, k, v, o, o_lo, dout, lse, dq, dk, dv),
                   dense_flops=10 * D * B * H * T * S)
        return dq, dk, dv
    if q.numel() == 0 or S == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    # The tensor-core paths sum each group of query heads' f32 partial dK /
    # dV in this scratch; the FMA path needs none, nor the wgmma path with
    # one group, which writes dK and dV itself.
    groups, partial = 0, None
    path = bwd_path(q.dtype, D, _aligned(q, k, v, dout, dq, dk, dv))
    if path:
        groups = bwd_groups(B, S, H, K, D)
    if path == 1 or groups > 1:
        partial = torch.empty(2 * groups * B * S * K * D, dtype=torch.float32,
                              device=q.device)
    fn = _bwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if o_lo is None else o_lo.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 None if partial is None else partial.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 _DTYPES[q.dtype], B, T, S, H, K, D, groups, int(causal),
                 int(window), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_cuda: launch failed with "
                           f"cudaError_t {err} (B={B} T={T} S={S} H={H} "
                           f"K={K} D={D})")
    BWD_LAUNCHES += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, saving (q, k, v, o, lse, o_lo); its backward is
    the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse, o_lo = _forward(q, k, v, causal, window, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, o_lo)
        ctx.args = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse, o_lo = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, o, lse, dout.to(q.dtype), causal=causal, window=window,
            scale=scale, o_lo=o_lo)
        return dq, dk, dv, None, None, None

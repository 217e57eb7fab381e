"""LayerNorm and RMSNorm over the last dim: the hand-written CUDA kernels,
forward and backward, and their wrapper.

``csrc/norm.cu`` replaces no TPU kernel: the JAX package writes its norms
in jnp (``repro.models.layers.apply_norm``, ``_qk_normalize``) and leaves
their fusion to XLA.  One launch normalises every row, reading x once and
writing y once, where the plain version (:func:`repro_torch.kernels.ref.norm_ref`,
the f32 chain of PyTorch ops) makes six or eleven passes over f32
temporaries; the backward is one launch of dx and per-block partial sums
of the scale's and bias's gradients, and one launch that adds the partials
in a fixed order.  Joined by a ``torch.autograd.Function``, which saves x,
the scale and each row's mean (LayerNorm) and rstd.  Built with ``nvcc``
for ``sm_90a`` at first use and bound through ctypes.  Given meta tensors
it launches nothing: it returns empty outputs of the kernels' shapes and
dtypes and records their work in :mod:`repro_torch.kernels.accounting`.
Reached through :func:`repro_torch.kernels.ops.norm`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import accounting as acc

SOURCE = "norm.cu"
REPLACES = None          # the JAX package's norms are jnp, fused by XLA
KINDS = {"rmsnorm": 0, "layernorm": 1}
MAX_WIDTH = 16384        # the widest row the kernels hold in registers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Forward launches and the rows they normalised, and backward calls (each
# two launches: dx with the partial sums, then their sum) in this process;
# read and reset by callers that must show a path went through the kernels.
LAUNCHES = 0
ROWS = 0
BWD_LAUNCHES = 0

# C signature of ``repro_norm_fwd``: x, ld, scale, bias, y, mean, rstd;
# dtype, layernorm, R, C, eps; stream.
ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
            + [ctypes.c_void_p])
# ``repro_norm_bwd_partials``: dtype, layernorm, R, C -> rows of partials.
PARTIALS_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_int]
# ``repro_norm_bwd``: x, ld, dy, scale, mean, rstd, dx, part, dscale, dbias;
# dtype, layernorm, R, C; stream.
BWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 8
                + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_int]
                + [ctypes.c_void_p])


@functools.cache
def _fns():
    lib = _build.load(SOURCE)
    fwd, parts, bwd = lib.repro_norm_fwd, lib.repro_norm_bwd_partials, lib.repro_norm_bwd
    for fn, args, res in ((fwd, ARGTYPES, ctypes.c_int),
                          (parts, PARTIALS_ARGTYPES, ctypes.c_longlong),
                          (bwd, BWD_ARGTYPES, ctypes.c_int)):
        fn.argtypes = args
        fn.restype = res
    return fwd, parts, bwd


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def row_stride(x: torch.Tensor) -> Optional[int]:
    """The stride between x's rows (its leading dims taken as one) when its
    last dim is contiguous and the leading dims collapse to one stride, as
    ``torch.split``'s views of a projection's last dim and ``x[:, -1:]``
    do; else None."""
    C = x.shape[-1]
    if C > 1 and x.stride(-1) != 1:
        return None
    ld = None
    for size, stride in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if size == 1:
            continue
        if ld is None:
            ld, span = stride, stride * size
        elif stride != span:
            return None
        else:
            span = stride * size
    ld = C if ld is None else ld
    return ld if ld >= C else None


def _check(x, scale, bias, kind):
    if not (x.is_cuda or x.is_meta):
        raise ValueError(f"norm_cuda: x is on {x.device}, not a CUDA device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"norm_cuda: x has dtype {x.dtype}; float32 or "
                        "bfloat16 only")
    if kind not in KINDS:
        raise ValueError(f"norm_cuda: kind {kind!r}, not one of {tuple(KINDS)}")
    if (kind == "layernorm") != (bias is not None):
        raise ValueError("norm_cuda: layernorm takes a bias, rmsnorm none")
    C = x.shape[-1] if x.dim() else 0
    if not 0 < C <= MAX_WIDTH:
        raise ValueError(f"norm_cuda: width {C} not in 1..{MAX_WIDTH}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.shape != (C,) or t.device != x.device
                              or t.dtype != torch.float32):
            raise ValueError(f"norm_cuda: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, expected ({C},) float32 on {x.device}")


def _vec(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().contiguous()


def _rows(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """x as the kernels read it, with its row stride: in place where its
    rows have one stride and a contiguous last dim, else made contiguous."""
    ld = row_stride(x)
    if ld is None:                       # rows of no single stride: copied
        x = x.contiguous()
        ld = x.shape[-1]
    return x, ld


def norm_fwd_cuda(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                  kind: str, eps: float
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """(y of x's shape and dtype, mean (R,) f32 for LayerNorm else None,
    rstd (R,) f32) over the R rows of x's last dim.  Raises on a CPU
    tensor, an unsupported dtype, kind or width, or a refused launch."""
    global LAUNCHES, ROWS
    _check(x, scale, bias, kind)
    x, ld = _rows(x.detach())
    scale, bias = _vec(scale), _vec(bias)
    C = x.shape[-1]
    R = x.numel() // C
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mean = torch.empty((R,), **f32) if kind == "layernorm" else None
    rstd = torch.empty((R,), **f32)
    if x.is_meta:
        # Elementwise arithmetic counts no FLOPs, as PyTorch's elementwise
        # ops count none in the dry run's dot-FLOP totals; one rsqrt a row.
        acc.record("norm", flops=0, special=R,
                   bytes=acc.nbytes(x, scale, bias, y, mean, rstd))
        return y, mean, rstd
    if R == 0:
        return y, mean, rstd
    fwd, _, _ = _fns()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fwd(x.data_ptr(), ld, scale.data_ptr(), _ptr(bias), y.data_ptr(),
                  _ptr(mean), rstd.data_ptr(), _DTYPES[x.dtype], KINDS[kind], R, C,
                  eps, stream)
    if err != 0:
        raise RuntimeError(f"norm_cuda: launch failed with cudaError_t {err} "
                           f"(R={R} C={C} ld={ld} {x.dtype} {kind})")
    LAUNCHES += 1
    ROWS += R
    return y, mean, rstd


def norm_bwd_cuda(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                  mean: Optional[torch.Tensor], rstd: torch.Tensor, kind: str
                  ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dx of x's shape and dtype, dscale (C,) f32, dbias (C,) f32 for
    LayerNorm else None) from dy, the forward's x, scale and statistics.
    Raises on a refused launch."""
    global BWD_LAUNCHES
    x, ld = _rows(x)
    dy = dy.to(x.dtype).contiguous()
    C = x.shape[-1]
    R = x.numel() // C
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dscale = torch.empty((C,), **f32)
    dbias = torch.empty((C,), **f32) if kind == "layernorm" else None
    if x.is_meta:
        acc.record("norm_bwd", flops=0, special=0,
                   bytes=acc.nbytes(x, dy, scale, mean, rstd, dx, dscale, dbias))
        return dx, dscale, dbias
    if R == 0:
        return dx, dscale.zero_(), None if dbias is None else dbias.zero_()
    _, parts, bwd = _fns()
    layernorm = KINDS[kind]
    with torch.cuda.device(x.device):
        P = parts(_DTYPES[x.dtype], layernorm, R, C)
        if P <= 0:
            raise RuntimeError(f"norm_bwd_cuda: shape refused with cudaError_t "
                               f"{-P} (R={R} C={C} {x.dtype} {kind})")
        part = torch.empty(((1 + layernorm) * P, C), **f32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = bwd(x.data_ptr(), ld, dy.data_ptr(), scale.data_ptr(), _ptr(mean),
                  rstd.data_ptr(), dx.data_ptr(), part.data_ptr(), dscale.data_ptr(),
                  _ptr(dbias), _DTYPES[x.dtype], layernorm, R, C, stream)
    if err != 0:
        raise RuntimeError(f"norm_bwd_cuda: launch failed with cudaError_t {err} "
                           f"(R={R} C={C} ld={ld} {x.dtype} {kind})")
    BWD_LAUNCHES += 1
    return dx, dscale, dbias


class _Norm(torch.autograd.Function):
    """The forward kernel, saving x, the scale and the rows' statistics; its
    backward is the backward kernels."""

    @staticmethod
    def forward(ctx, x, scale, bias, kind, eps):
        y, mean, rstd = norm_fwd_cuda(x, scale, bias, kind, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.kind = kind
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = norm_bwd_cuda(dy, x.detach(), _vec(scale), mean, rstd,
                                          ctx.kind)
        needs = ctx.needs_input_grad
        return (dx if needs[0] else None, dscale if needs[1] else None,
                dbias if needs[2] else None, None, None)


def norm_cuda(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
              kind: str, eps: float) -> torch.Tensor:
    """``kind`` ("layernorm" or "rmsnorm") over the last dim of x (f32 or
    bf16, on a CUDA device or meta), with an f32 scale (C,) and, for
    LayerNorm, an f32 bias (C,): y in x's dtype, as
    :func:`repro_torch.kernels.ref.norm_ref`.  When grad is enabled and an
    input requires it, y carries a graph whose backward is the backward
    kernels.  Raises on a CPU tensor, an unsupported dtype, kind or width,
    or a refused launch."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, bias)):
        return _Norm.apply(x, scale, bias, kind, eps)
    return norm_fwd_cuda(x, scale, bias, kind, eps)[0]

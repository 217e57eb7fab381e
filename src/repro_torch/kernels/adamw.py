"""The AdamW update of one parameter leaf: the hand-written CUDA kernel and
its wrapper.

``csrc/adamw.cu`` replaces no TPU kernel: the JAX package leaves AdamW to
XLA's fusion.  It does in one pass over a leaf what the slice loop of
:func:`repro_torch.train.optimizer.update_in_slices` (the plain version)
does in about two dozen PyTorch kernels, with the same bits.  Built with
``nvcc`` for ``sm_90a`` at first use and bound through ctypes.  Given meta
tensors it launches nothing and records the kernel's work in
:mod:`repro_torch.kernels.accounting`.  Reached through
:func:`repro_torch.kernels.ops.adamw`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import accounting as acc

SOURCE = "adamw.cu"
REPLACES = None          # the JAX package's AdamW is jnp, fused by XLA
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32, _BF16 = torch.float32, torch.bfloat16
# The (p, g, moments) dtype sets the kernel is built for: the port's
# default, f32 throughout, f32 gradients accumulated over microbatches, and
# bf16 moments (llama3-405b).
DTYPE_SETS = ((_BF16, _BF16, _F32), (_F32, _F32, _F32), (_BF16, _F32, _F32),
              (_BF16, _BF16, _BF16))

# Kernel launches and the elements they updated in this process; read and
# reset by callers that must show a path went through the kernel.
LAUNCHES = 0
ELEMENTS = 0

# C signature of ``repro_adamw_update``: p, g, m, v, clip, bc1, bc2; the
# dtypes of p, g and the moments; n; decay; b1, 1 - b1, b2, 1 - b2, eps, lr,
# weight decay; stream.
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
            + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_float] * 7
            + [ctypes.c_void_p])


@functools.cache
def _fn():
    fn = _build.load(SOURCE).repro_adamw_update
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def adamw_cuda(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, clip: torch.Tensor, bc1: torch.Tensor,
               bc2: torch.Tensor, *, lr: float, b1: float, b2: float,
               eps: float, weight_decay: float, decay: bool) -> None:
    """One AdamW step of one leaf, in place: p, m and v get the values
    :func:`repro_torch.train.optimizer.update_in_slices` writes, bit for bit.

    p, g and m/v in one of ``DTYPE_SETS``; g of p's number of elements; m,
    v of p's shape; clip, bc1, bc2: 0-d f32, all on one CUDA device (or all
    meta).  p, m and v must be contiguous (they are written in place, and
    their autograd version counters are bumped as an in-place op's are); g
    is made contiguous.  Decoupled weight decay when ``decay``.  Raises on
    a CPU tensor, an unsupported dtype set, a mismatched shape, a
    non-contiguous p, m or v, or a refused launch; reads no value back to
    the host."""
    global LAUNCHES, ELEMENTS
    tensors = {"p": p, "g": g, "m": m, "v": v, "clip": clip, "bc1": bc1, "bc2": bc2}
    for name, t in tensors.items():
        if t.device != p.device or not (t.is_cuda or t.is_meta):
            raise ValueError(f"adamw_cuda: {name} is on {t.device}; every "
                             f"tensor must be on one CUDA device (p: {p.device})")
    if v.dtype != m.dtype or (p.dtype, g.dtype, m.dtype) not in DTYPE_SETS:
        raise TypeError(f"adamw_cuda: dtypes p {p.dtype}, g {g.dtype}, m "
                        f"{m.dtype}, v {v.dtype}; (p, g, moments) must be one "
                        f"of {DTYPE_SETS}")
    for name in ("clip", "bc1", "bc2"):
        t = tensors[name]
        if t.dtype != torch.float32 or t.dim() != 0:
            raise TypeError(f"adamw_cuda: {name} must be a 0-d float32 tensor, "
                            f"got {t.dtype} of shape {tuple(t.shape)}")
    if m.shape != p.shape or v.shape != p.shape or g.numel() != p.numel():
        raise ValueError(f"adamw_cuda: shapes p {tuple(p.shape)}, g "
                         f"{tuple(g.shape)}, m {tuple(m.shape)}, v {tuple(v.shape)}")
    for name in ("p", "m", "v"):
        if not tensors[name].is_contiguous():
            raise ValueError(f"adamw_cuda: {name} is not contiguous; it is "
                             "written in place")
    g = g.contiguous()
    n = p.numel()
    if n == 0:
        return
    if p.is_meta:
        # Elementwise arithmetic counts no FLOPs, as PyTorch's elementwise
        # ops count none in the dry run's dot-FLOP totals; one square root
        # an element.
        acc.record("adamw", flops=0, special=n,
                   bytes=acc.nbytes(p, g, m, v) + acc.nbytes(p, m, v))
        return
    fn = _fn()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 clip.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
                 _DTYPES[p.dtype], _DTYPES[g.dtype], _DTYPES[m.dtype], n,
                 int(decay), b1, 1 - b1, b2, 1 - b2, eps, lr, weight_decay,
                 stream)
    if err != 0:
        raise RuntimeError(f"adamw_cuda: launch failed with cudaError_t {err} "
                           f"(n={n})")
    torch.autograd.graph.increment_version((p, m, v))
    LAUNCHES += 1
    ELEMENTS += n

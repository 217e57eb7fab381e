"""``kernels.ops.norm`` off the card: the CPU route and the meta route.

* On the CPU, ``ops.norm`` (and so ``layers.apply_norm`` and
  ``layers._qk_normalize``) is the f32 chain the model code ran before the
  norm kernel, bit for bit, forward and through autograd (the chain is
  written out below as it stood in ``models/layers.py``), for LayerNorm
  and RMSNorm, f32 and bf16, contiguous and strided rows.
* On meta tensors it launches nothing: the outputs and gradients have the
  kernels' shapes and dtypes, and ``kernels.accounting`` records one
  ``norm`` (bytes of x, scale, bias, y and the f32 row statistics; one
  rsqrt a row) and one ``norm_bwd`` a call (bytes of x, dy, scale,
  statistics, dx and the f32 gradients).
* ``norm.row_stride`` reads split views and ``x[:, -1:]`` in place.

The kernels themselves are held against ``ref.norm_ref`` on the card in
``tests/test_torch_cuda.py``.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs.registry import tiny_config
from repro_torch.kernels import accounting as acc
from repro_torch.kernels import norm as NK
from repro_torch.kernels import ops
from repro_torch.models import layers as L

EPS = 1e-6
KINDS = ("layernorm", "rmsnorm")


def old_apply_norm(scale, bias, x, kind, eps=EPS):
    """``layers.apply_norm`` before the kernel."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    else:
        y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps)
        y = y * scale
    return y.to(x.dtype)


def old_qk_normalize(x, scale, eps=EPS):
    """``layers._qk_normalize`` before the kernel."""
    xf = x.float()
    y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps) * scale
    return y.to(x.dtype)


def _inputs(kind, dtype, strided, seed=0):
    g = torch.Generator().manual_seed(seed)
    C = 24
    if strided:          # a split view of a wider projection, as Jamba's x_proj
        x = (torch.randn(3, 5, C + 8, generator=g) * 2 + 0.5)[..., 4:4 + C]
    else:
        x = torch.randn(3, 5, C, generator=g) * 2 + 0.5
    x = x.to(dtype)
    scale = 1 + 0.1 * torch.randn(C, generator=g)
    bias = 0.1 * torch.randn(C, generator=g) if kind == "layernorm" else None
    return x, scale, bias


def _leaves(x, scale, bias):
    return [t.detach().clone().requires_grad_(True) if t is not None else None
            for t in (x, scale, bias)]


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_cpu_norm_is_the_old_chain_bit_for_bit(kind, dtype, strided):
    x, scale, bias = _inputs(kind, dtype, strided)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    runs = []
    for fn in (lambda a, s, b: ops.norm(a, s, b, kind, EPS),
               lambda a, s, b: old_apply_norm(s, b, a, kind)):
        xs, ss, bs = _leaves(x, scale, bias)
        y = fn(xs, ss, bs)
        grads = torch.autograd.grad(y, [t for t in (xs, ss, bs) if t is not None], dy)
        runs.append((y, grads))
    (y1, g1), (y2, g2) = runs
    assert y1.dtype == dtype and torch.equal(y1, y2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_layers_route_through_ops_norm(kind):
    cfg = dataclasses.replace(tiny_config("qwen3-32b"), norm=kind)
    x, scale, bias = _inputs(kind, torch.bfloat16, False)
    p = {"scale": scale} if bias is None else {"scale": scale, "bias": bias}
    assert torch.equal(L.apply_norm(p, x, cfg), old_apply_norm(scale, bias, x, kind))
    assert torch.equal(L._qk_normalize(x, scale), old_qk_normalize(x, scale))


def _meta(shape, dtype, kind):
    C = shape[-1]
    x = torch.empty(shape, dtype=dtype, device="meta", requires_grad=True)
    scale = torch.empty((C,), device="meta", requires_grad=True)
    bias = (torch.empty((C,), device="meta", requires_grad=True)
            if kind == "layernorm" else None)
    return x, scale, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_meta_norm_records_bytes_and_launches(kind, dtype):
    R, C = 2 * 7, 160
    x, scale, bias = _meta((2, 7, C), dtype, kind)
    launches = NK.LAUNCHES, NK.BWD_LAUNCHES
    acc.reset()
    y = ops.norm(x, scale, bias, kind, EPS)
    assert y.shape == x.shape and y.dtype == dtype and y.is_meta
    grads = torch.autograd.grad(y, [t for t in (x, scale, bias) if t is not None],
                                torch.empty_like(y))
    assert [(g.shape, g.dtype) for g in grads] == [
        (t.shape, t.dtype) for t in (x, scale, bias) if t is not None]
    e = x.element_size()
    n_vec = 1 + (kind == "layernorm")           # scale (and bias), f32
    n_stat = 1 + (kind == "layernorm")          # rstd (and mean), f32 a row
    counts = acc.snapshot()
    assert counts["norm"] == dict(flops=0, special=R, dense_flops=0, launches=1,
                                  bytes=2 * R * C * e + 4 * n_vec * C + 4 * n_stat * R)
    assert counts["norm_bwd"] == dict(flops=0, special=0, dense_flops=0, launches=1,
                                      bytes=3 * R * C * e + 4 * C + 4 * n_stat * R
                                      + 4 * n_vec * C)
    assert (NK.LAUNCHES, NK.BWD_LAUNCHES) == launches     # nothing launched


def test_meta_norm_without_grad_records_the_forward_alone():
    x, scale, _ = _meta((4, 1, 3072), torch.bfloat16, "rmsnorm")
    acc.reset()
    with torch.no_grad():
        ops.norm(x, scale, None, "rmsnorm", EPS)
    assert set(acc.snapshot()) == {"norm"}


def test_row_stride_reads_views_in_place():
    proj = torch.empty(2, 3, 192)
    assert NK.row_stride(proj) == 192
    assert NK.row_stride(proj[..., :160]) == 192           # dt of x_proj
    assert NK.row_stride(proj[..., 160:176]) == 192        # B
    assert NK.row_stride(proj[:, -1:]) == 3 * 192          # prefill's last position
    assert NK.row_stride(proj[:1, :1]) == 192              # one row
    assert NK.row_stride(proj.transpose(0, 1)) is None     # rows of two strides
    assert NK.row_stride(proj[..., ::2]) is None           # strided last dim


def test_norm_cuda_refuses_what_the_kernels_do_not_take():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="not a CUDA device"):
        NK.norm_cuda(x, torch.ones(8), None, "rmsnorm", EPS)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="width"):
        NK.norm_cuda(torch.empty(2, NK.MAX_WIDTH + 1, **meta),
                     torch.empty(NK.MAX_WIDTH + 1, **meta), None, "rmsnorm", EPS)
    with pytest.raises(TypeError, match="dtype"):
        NK.norm_cuda(torch.empty(2, 8, dtype=torch.float16, **meta),
                     torch.empty(8, **meta), None, "rmsnorm", EPS)
    with pytest.raises(ValueError, match="kind"):
        NK.norm_cuda(torch.empty(2, 8, **meta), torch.empty(8, **meta), None,
                     "batchnorm", EPS)
    with pytest.raises(ValueError, match="bias"):
        NK.norm_cuda(torch.empty(2, 8, **meta), torch.empty(8, **meta),
                     torch.empty(8, **meta), "rmsnorm", EPS)
    with pytest.raises(ValueError, match="bias"):
        NK.norm_cuda(torch.empty(2, 8, **meta), torch.empty(8, **meta), None,
                     "layernorm", EPS)
    with pytest.raises(ValueError, match="float32"):
        NK.norm_cuda(torch.empty(2, 8, **meta),
                     torch.empty(8, dtype=torch.bfloat16, **meta), None, "rmsnorm", EPS)

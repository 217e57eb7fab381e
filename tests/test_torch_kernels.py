"""Port kernels against the JAX reference.

The plain PyTorch attention (the CPU route of ``ops.flash_attention``) is
held against ``repro.kernels.ref.attention_ref`` and against the Pallas
kernel run in interpret mode, over the reference's ATTN_CASES, with the
reference's tolerances (f32 2e-5, bf16 2e-2); its gradients are held
against ``jax.grad`` of the reference's chunked attention at 1e-4.  The
plain quantization must give exactly the reference's and the Pallas
kernel's int8 codes, and ``grad_compress`` the reference's results.  The
CUDA kernels themselves run only on a card: their tests are in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.quantize import quantize_pallas  # noqa: E402
from repro.train import grad_compress as jgc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,  # noqa: E402
                                                 flash_attention_cuda)
from repro_torch.kernels.quantize import quantize_cuda  # noqa: E402
from repro_torch.train import grad_compress as tgc  # noqa: E402

# B, T, S, H, K, D, causal, window -- as tests/test_kernels.py ATTN_CASES.
ATTN_CASES = [
    (2, 16, 16, 4, 4, 8, True, 0),        # MHA causal
    (1, 16, 16, 6, 2, 16, True, 0),       # GQA rep=3
    (2, 8, 24, 4, 1, 8, True, 0),         # MQA, suffix queries (prefill)
    (1, 16, 16, 4, 2, 8, False, 0),       # bidirectional (encoder)
    (1, 32, 32, 4, 4, 8, True, 8),        # local window
    (1, 20, 20, 2, 2, 8, True, 0),        # non-multiple-of-block lengths
]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np_qkv(seed, B, T, S, H, K, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D), dtype=np.float32),
            rng.standard_normal((B, S, K, D), dtype=np.float32),
            rng.standard_normal((B, S, K, D), dtype=np.float32))


def _both(arrays, jdt, tdt):
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_attention_plain_vs_reference(case, dt):
    B, T, S, H, K, D, causal, window = case
    jdt, tdt, tol = DTYPES[dt]
    (jq, jk, jv), (tq, tk, tv) = _both(_np_qkv(0, B, T, S, H, K, D), jdt, tdt)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    got = ref.attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (B, T, H, D)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    # ops.flash_attention on a CPU tensor is the plain version.
    np.testing.assert_array_equal(
        _f32(ops.flash_attention(tq, tk, tv, causal=causal, window=window)),
        _f32(got))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_plain_vs_pallas_interpret(case):
    B, T, S, H, K, D, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _both(_np_qkv(1, B, T, S, H, K, D),
                                       jnp.float32, torch.float32)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  block_q=8, block_k=8, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


def test_attention_fully_masked_rows_are_zero():
    # More queries than keys: the first T-S rows see no key at all.
    (_, _, _), (tq, tk, tv) = _both(_np_qkv(2, 1, 12, 4, 2, 1, 8),
                                    jnp.float32, torch.float32)
    out = ref.attention_ref(tq, tk, tv, causal=True)
    assert torch.all(out[:, :8] == 0) and torch.all(out[:, 8:].abs().sum(-1) > 0)


DECODE_CASES = [
    # B, S, H, K, D, cache_len, window
    (2, 16, 4, 2, 8, 16, 0),
    (1, 24, 6, 2, 16, 9, 0),
    (2, 20, 4, 1, 8, 20, 8),
    (1, 12, 4, 4, 8, 1, 0),
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_decode_attention_vs_reference(case, dt):
    B, S, H, K, D, cache_len, window = case
    jdt, tdt, tol = DTYPES[dt]
    (jq, jk, jv), (tq, tk, tv) = _both(_np_qkv(3, B, 1, S, H, K, D), jdt, tdt)
    want = jops.decode_attention(jq, jk, jv, jnp.int32(cache_len),
                                 window=window)
    got = ops.decode_attention(tq, tk, tv, cache_len, window=window)
    assert got.dtype == tdt and got.shape == (B, 1, H, D)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_flash_attention_cuda_rejects_cpu_tensors():
    """No hidden fallback: the CUDA wrapper never runs the plain version."""
    q = torch.zeros(1, 4, 2, 8)
    k = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_cuda(q, k, k)


@pytest.mark.parametrize("module,source,symbol,argtypes", [
    ("flash_attention", "SOURCE", "repro_flash_attention_fwd", "ARGTYPES"),
    ("flash_attention", "BWD_SOURCE", "repro_flash_attention_bwd", "BWD_ARGTYPES"),
    ("flash_attention", "SOURCE", "repro_flash_attention_fwd_path", "PATH_ARGTYPES"),
    ("flash_attention", "BWD_SOURCE", "repro_flash_attention_bwd_path", "PATH_ARGTYPES"),
    ("flash_attention", "BWD_SOURCE", "repro_flash_attention_bwd_groups",
     "GROUPS_ARGTYPES"),
    ("ssm_scan", "SOURCE", "repro_ssm_scan_fwd", "ARGTYPES"),
    ("rglru_scan", "SOURCE", "repro_rglru_scan_fwd", "ARGTYPES"),
    ("quantize", "SOURCE", "repro_quantize_fwd", "ARGTYPES"),
])
def test_ctypes_signature_matches_cuda_source(module, source, symbol, argtypes):
    """The ctypes argument list agrees with the C entry point's prototype."""
    import ctypes
    import importlib
    import re

    from repro_torch.kernels import _build
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    src = (_build.CSRC / getattr(mod, source)).read_text()
    proto = re.search(rf'extern "C" int {symbol}\((.*?)\)', src, re.S).group(1)
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    types = [re.fullmatch(r"(?:const\s+)?(\w+\s*\*?)\s*\w+", p.strip()).group(1)
             for p in proto.split(",")]
    assert [ctype[t.replace(" ", "")] for t in types] == getattr(mod, argtypes)


# --------------------------------------------------------------------------
# gradients of attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_grads_vs_reference_chunked(case):
    """Autograd through the plain attention (the CPU route of
    ``ops.flash_attention``) against ``jax.grad`` of the reference's chunked
    attention, which is what the reference trains through."""
    B, T, S, H, K, D, causal, window = case
    arrays = _np_qkv(12, B, T, S, H, K, D)
    dout = np.random.default_rng(13).standard_normal((B, T, H, D), dtype=np.float32)

    def jloss(q, k, v):
        o = jops.flash_attention(q, k, v, causal=causal, window=window,
                                 q_chunk=8, kv_chunk=8)
        return jnp.sum(o * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for g, w in zip(got, want):
        assert bool(g.abs().sum() > 0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_flash_attention_under_grad_on_cpu_reaches_q_k_v():
    (_, _, _), (tq, tk, tv) = _both(_np_qkv(14, 1, 12, 12, 4, 2, 8),
                                    jnp.float32, torch.float32)
    for x in (tq, tk, tv):
        x.requires_grad_()
    out = ops.flash_attention(tq, tk, tv, causal=True)
    out.square().sum().backward()
    for x in (tq, tk, tv):
        assert x.grad is not None and bool(x.grad.abs().sum() > 0)


def test_cuda_wrappers_reject_cpu_tensors():
    q = torch.zeros(1, 4, 2, 8)
    k = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_bwd_cuda(q, k, k, q, torch.zeros(1, 2, 4), q)
    with pytest.raises(ValueError, match="not a CUDA device"):
        quantize_cuda(torch.zeros(3, 4))


# --------------------------------------------------------------------------
# int8 quantization and gradient compression
# --------------------------------------------------------------------------
def _quant_rows(shape):
    if shape == "ties":
        # amax 127 and 254 give scales 1 and 2: codes land on exact .5 ties.
        h = np.arange(16, dtype=np.float32) % 8 - 3.5
        r1, r2 = h.copy(), 2 * h
        r1[0], r2[-1] = 127.0, -254.0
        return np.stack([r1, r2, -r1])
    if shape == "zero-row":
        x = 3 * np.random.default_rng(15).standard_normal((4, 40), dtype=np.float32)
        x[1] = 0.0
        return x
    return 3 * np.random.default_rng(16).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("shape", [(8, 16), (7, 33), (128, 256), (1, 5),
                                   "ties", "zero-row"], ids=str)
def test_quantize_plain_vs_reference_and_pallas(shape):
    x = _quant_rows(shape)
    qr, sr = jref.quantize_ref(jnp.asarray(x))
    qp, sp = quantize_pallas(jnp.asarray(x))
    q, s = ops.quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.shape == (x.shape[0], 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qp))
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ops.dequantize(q, s).numpy(),
                               np.asarray(jref.dequantize_ref(qr, sr)),
                               atol=1e-6, rtol=1e-6)
    if shape == "ties":      # half to even: -2.5 .. 3.5 -> -2 -2 0 0 2 2 4
        assert q[0, 1:8].tolist() == [-2, -2, 0, 0, 2, 2, 4]


# Leaves under 1024 values, not a multiple of 1024, several full rows, bf16.
LEAVES = [((5, 7), "f32"), ((3, 700), "f32"), ((4, 512), "f32"),
          ((40, 64), "bf16")]


def _leaf(shape, dt, seed):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    jdt, tdt, _ = DTYPES[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("shape,dt", LEAVES, ids=str)
def test_grad_compress_vs_reference(shape, dt):
    (jg, tg), (je, te) = _leaf(shape, dt, 17), _leaf(shape, "f32", 18)
    je, te = 0.01 * je, 0.01 * te
    jq, js = jgc.compress(jg)
    tq, ts = tgc.compress(tg)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=1e-6)
    back = tgc.decompress(tq, ts, tg.shape, tg.dtype)
    assert back.shape == tg.shape and back.dtype == tg.dtype
    np.testing.assert_array_equal(
        _f32(back), _f32(jgc.decompress(jq, js, jg.shape, jg.dtype)))
    jout = jgc.ef_round(jg, je)
    tout = tgc.ef_round(tg, te)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    for got, want in zip(tout[1:], jout[1:]):
        assert got.dtype == {jnp.float32: torch.float32,
                             jnp.bfloat16: torch.bfloat16}[want.dtype.type]
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6, rtol=1e-6)
    assert set(tgc.ef_init({"a": tg})) == {"a"}
    assert bool((tgc.ef_init({"a": tg})["a"] == 0).all())

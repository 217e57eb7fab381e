"""Port kernels against the JAX reference.

The plain PyTorch attention (the CPU route of ``ops.flash_attention``) is
held against ``repro.kernels.ref.attention_ref`` and against the Pallas
kernel run in interpret mode, over the reference's ATTN_CASES, with the
reference's tolerances (f32 2e-5, bf16 2e-2).  The CUDA kernel itself runs
only on a card: its tests are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402

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


@pytest.mark.parametrize("module,symbol", [
    ("flash_attention", "repro_flash_attention_fwd"),
    ("ssm_scan", "repro_ssm_scan_fwd"),
    ("rglru_scan", "repro_rglru_scan_fwd"),
])
def test_ctypes_signature_matches_cuda_source(module, symbol):
    """The ctypes argument list agrees with the C entry point's prototype."""
    import ctypes
    import importlib
    import re

    from repro_torch.kernels import _build
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    src = (_build.CSRC / mod.SOURCE).read_text()
    proto = re.search(rf'extern "C" int {symbol}\((.*?)\)', src, re.S).group(1)
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    types = [re.fullmatch(r"(?:const\s+)?(\w+\s*\*?)\s*\w+", p.strip()).group(1)
             for p in proto.split(",")]
    assert [ctype[t.replace(" ", "")] for t in types] == mod.ARGTYPES

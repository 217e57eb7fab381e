"""The CUDA kernels on the card, against their plain versions.

Marked ``gpu``: they skip without a CUDA card.  This file imports no JAX, so
it runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q

Tolerances are those ``chip_smoke.py`` holds the kernels to: f32 1e-4 (sums
in another order than the plain version), bf16 outputs 2e-2, and the scans'
f32 final states 1e-4 whatever the input dtype.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels import ssm_scan as ss

# B, T, S, H, K, D, causal, window -- tests/test_kernels.py ATTN_CASES, then
# cases on the tensor-core path (bf16, D in {16, 32, 64, 128}) with ragged
# tiles, suffix queries, a window and rows that see no key (T > S).
CASES = [
    (2, 16, 16, 4, 4, 8, True, 0),
    (1, 16, 16, 6, 2, 16, True, 0),
    (2, 8, 24, 4, 1, 8, True, 0),
    (1, 16, 16, 4, 2, 8, False, 0),
    (1, 32, 32, 4, 4, 8, True, 8),
    (1, 20, 20, 2, 2, 8, True, 0),
    (1, 100, 100, 4, 2, 128, True, 24),
    (2, 65, 130, 8, 2, 64, True, 0),
    (2, 24, 8, 4, 2, 32, True, 0),
]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_cuda_vs_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, S, H, K, D, causal, window = case
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to(dtype).cuda()
               for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)


# B, T, I, N -- tests/test_kernels.py SSM_CASES, then T past one tile, I not
# a multiple of the 128-channel block, and the full state size.
SSM_CASES = [(1, 8, 4, 2), (2, 16, 8, 4), (1, 24, 6, 3), (2, 20, 200, 16),
             (1, 1000, 130, 16), (3, 17, 64, 8)]
# B, T, L -- tests/test_kernels.py RGLRU_CASES, then T not a multiple of 16
# and L not a multiple of the 64-channel block.
RGLRU_CASES = [(1, 8, 4), (2, 16, 8), (1, 13, 6), (1, 20, 6), (2, 1000, 100),
               (3, 33, 64)]


def _cuda(rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype).cuda()


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
def test_ssm_scan_cuda_vs_plain(case, dtype, with_h0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Bt, T, I, N = case
    rng = np.random.default_rng(5)
    x = _cuda(rng, (Bt, T, I), dtype)
    dt = torch.nn.functional.softplus(_cuda(rng, (Bt, T, I)))
    A = -torch.exp(_cuda(rng, (I, N)))
    Bm, Cm = _cuda(rng, (Bt, T, N), dtype), _cuda(rng, (Bt, T, N), dtype)
    D = _cuda(rng, (I,))
    h0 = _cuda(rng, (Bt, I, N)) if with_h0 else None
    before = ss.LAUNCHES
    y, hT = ops.ssm_scan(x, dt, A, Bm, Cm, D, h0)
    torch.cuda.synchronize()
    assert ss.LAUNCHES == before + 1
    assert y.dtype == dtype and hT.dtype == torch.float32
    y_ref, hT_ref = ref.ssm_scan_ref(x, dt, A, Bm, Cm, D, h0)
    _close(y, y_ref, TOL[dtype])
    _close(hT, hT_ref, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("case", RGLRU_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
def test_rglru_scan_cuda_vs_plain(case, dtype, with_h0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, L = case
    rng = np.random.default_rng(6)
    x, a, i = (_cuda(rng, (B, T, L), dtype) for _ in range(3))
    lam = _cuda(rng, (L,))
    h0 = _cuda(rng, (B, L)) if with_h0 else None
    before = rs.LAUNCHES
    hs, hT = ops.rglru(x, a, i, lam, h0)
    torch.cuda.synchronize()
    assert rs.LAUNCHES == before + 1
    assert hs.dtype == dtype and hT.dtype == torch.float32
    hs_ref, hT_ref = ref.rglru_ref(x, a, i, lam, h0)
    _close(hs, hs_ref, TOL[dtype])
    _close(hT, hT_ref, 1e-4)

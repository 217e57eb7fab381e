"""The CUDA kernels on the card, against their plain versions.

Marked ``gpu``: they skip without a CUDA card.  This file imports no JAX, so
it runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q

Tolerances are those ``chip_smoke.py`` holds the kernel to: f32 1e-4 (sums
in another order than the plain version), bf16 2e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

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

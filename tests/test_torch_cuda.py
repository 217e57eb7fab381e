"""The CUDA kernels on the card, against their plain versions.

Marked ``gpu``: they skip without a CUDA card.  This file imports no JAX, so
it runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q

Tolerances are those ``chip_smoke.py`` holds the kernels to: f32 1e-4 (sums
in another order than the plain version), bf16 outputs 2e-2, and the scans'
f32 final states 1e-4 whatever the input dtype.  The flash backward is held
against autograd of the plain attention at the same tolerances, must give
the same bits on two calls, and takes the tensor cores at the bf16 shapes
of the main paths; the quantize kernel's int8 codes must equal the plain
version's exactly.  The scans' backward kernels are held against autograd
of the plain scans in f32 (tolerances stated beside those tests) and must
give the same bits on two calls.  The fused AdamW update must give the bits
of the slice loop it replaces (``update_in_slices``), with no tolerance.
The norm kernels are held against the plain chain (``ref.norm_ref``) and
autograd through it at f32 1e-5 and bf16 2e-2 (reasons beside those tests),
and must give the same bits on two backward calls.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw as AK
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels import ssm_scan as ss
from repro_torch.train import optimizer as TO

# B, T, S, H, K, D, causal, window -- tests/test_kernels.py ATTN_CASES, then
# cases on the tensor-core path (bf16, D in {16, 32, 64, 128, 256}) with
# ragged tiles, suffix queries, a window and rows that see no key (T > S).
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
# Head dim 256 (recurrentgemma's local layers), on the tensor-core path in
# bf16: T ragged against the forward's 128-row query tile and 64-key KV
# tile (the backward's 32-row tiles too), rows that see no key (T > S),
# non-causal with T != S, a window that empties whole KV tiles, suffix
# queries, and H/K in {1, 2, 16}.
D256_CASES = [
    (1, 100, 100, 2, 2, 256, True, 0),
    (2, 40, 24, 4, 2, 256, True, 0),
    (1, 33, 90, 16, 1, 256, False, 0),
    (1, 300, 300, 16, 1, 256, True, 64),
    (1, 130, 200, 4, 2, 256, True, 48),
]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES + D256_CASES)
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


# The flash shapes of the MoE, encoder-decoder and vision archs' main paths:
# whisper-small's encoder (non-causal, T = S = 1500) and cross-attention
# (non-causal, 448 queries over 1500 keys), paligemma-3b's training shape
# (MQA 8:1, head dim 256, 256 patches + 512 tokens, no window), granite's
# and phi3.5's prefill.
ARCH_SHAPES = [
    (4, 1500, 1500, 12, 12, 64, False, 0),
    (4, 448, 1500, 12, 12, 64, False, 0),
    (4, 768, 768, 8, 1, 256, True, 0),
    (4, 1024, 1024, 16, 8, 64, True, 0),
    (4, 1024, 1024, 32, 8, 128, True, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ARCH_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_at_the_new_arch_shapes(case, dtype):
    """Forward against plain; bf16 on the tensor cores (wgmma at head dims
    64, 128 and 256), f32 on the FMA kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, S, H, K, D, causal, window = case
    bf16_path = 2 if D in fa.WGMMA_TILES else 1
    assert fa.fwd_path(dtype, D) == (bf16_path if dtype == torch.bfloat16 else 0)
    rng = np.random.default_rng(5)
    q, k, v = (_cuda(rng, shape, dtype)
               for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))
    before = fa.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    _close(got, ref.attention_ref(q, k, v, causal=causal, window=window),
           TOL[dtype])


# B, T, I, N -- tests/test_kernels.py SSM_CASES, then T past one tile, I not
# a multiple of a channel block, and the full state size; then the
# chunked kernel's edges (ss.CHUNK = 64 steps, ss.SEGMENT = 16, ss.CHANNELS
# = 64): T in {1, SEGMENT - 1, CHUNK, CHUNK + 3, 2 CHUNK + 17, 200}, I a
# ragged block on the plain-load route (71, 33) and on the cp.async route
# (72, 80), N in {1, 5, 12, 16}.
SSM_CASES = [(1, 8, 4, 2), (2, 16, 8, 4), (1, 24, 6, 3), (2, 20, 200, 16),
             (1, 1000, 130, 16), (3, 17, 64, 8),
             (2, 145, 71, 16), (1, 1, 5, 1), (2, 15, 16, 5), (1, 64, 33, 16),
             (3, 67, 72, 5), (1, 200, 80, 12)]
# B, T, L -- tests/test_kernels.py RGLRU_CASES, then T not a multiple of 16
# and L not a multiple of the 64-channel block; then the chunked kernel's
# edges (rs.CHUNK = 64, rs.SEGMENT = 16, rs.CHANNELS = 64): T in {1,
# SEGMENT - 1, CHUNK, CHUNK + 3, 2 CHUNK + 17, 200}, L a ragged block on the
# plain-load route (71, 3) and on the cp.async route (72, 136; 100 in f32).
RGLRU_CASES = [(1, 8, 4), (2, 16, 8), (1, 13, 6), (1, 20, 6), (2, 1000, 100),
               (3, 33, 64),
               (2, 145, 71), (1, 1, 3), (2, 15, 64), (1, 64, 100), (3, 67, 72),
               (1, 200, 136)]


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


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["ssm_scan", "rglru_scan"])
def test_scan_kernels_are_deterministic_at_the_main_shapes(kernel):
    """The scan order is fixed, so two calls at the main-path shapes
    (falcon-mamba-7b and recurrentgemma-9b prefill, B=4, bf16) give the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(8)
    if kernel == "ssm_scan":
        Bt, T, I, N = 4, 1024, 8192, 16
        args = (_cuda(rng, (Bt, T, I), torch.bfloat16),
                torch.nn.functional.softplus(_cuda(rng, (Bt, T, I))),
                -torch.exp(_cuda(rng, (I, N))),
                _cuda(rng, (Bt, T, N), torch.bfloat16),
                _cuda(rng, (Bt, T, N), torch.bfloat16), _cuda(rng, (I,)))
        run = ss.ssm_scan_cuda
    else:
        B, T, L = 4, 3000, 4096
        args = tuple(_cuda(rng, (B, T, L), torch.bfloat16) for _ in range(3)) + (
            _cuda(rng, (L,)),)
        run = rs.rglru_scan_cuda
    first, second = run(*args), run(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# The forward's cases plus every head dim the backward templates on (16, 32,
# 64, 128, 256), a window that empties no row, and the starcoder2-3b shape
# at B=1.
BWD_CASES = CASES + [
    (1, 40, 40, 4, 2, 256, True, 16),
    (1, 70, 70, 4, 4, 32, False, 0),
    (2, 33, 50, 4, 1, 16, True, 0),
    (1, 1024, 1024, 24, 2, 128, True, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_bwd_cuda_vs_autograd_of_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, S, H, K, D, causal, window = case
    rng = np.random.default_rng(7)
    q, k, v = (_cuda(rng, shape, dtype).requires_grad_()
               for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))
    dout = _cuda(rng, (B, T, H, D), dtype)
    before, before_bwd = fa.LAUNCHES, fa.BWD_LAUNCHES
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (before + 1, before_bwd + 1)
    # Plain in f32 on the same values: bf16 autograd of the plain attention
    # rounds each query head's dK/dV before summing the GQA group.
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(
        ref.attention_ref(qf, kf, vf, causal=causal, window=window),
        (qf, kf, vf), dout.float())
    for g, w in zip(got, want):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        _close(g, w, TOL[dtype])


# (case, groups): bf16 cases of the tensor-core backward, with the number of
# groups G the dK/dV pass splits each KV head's H/K query heads into at
# that shape.  GQA group sizes 1, 3 and 12; G = 2 at a group of 3, which it
# does not divide; ragged T and S, T > S, suffix queries, a window, a
# non-causal T != S, and the starcoder2-3b training shape (B=4, G=4).
# Head dim 256 (the wgmma kernel's 64-key dK/dV blocks) at recurrentgemma's
# GQA 16:1 and at 2:1: causal, a window that empties whole tiles, T > S,
# non-causal T != S, G = 6 over a group of 16, which it does not divide, and
# recurrentgemma-9b's local training shape (B=2, T=3000, window 2048, G=3).
TRAIN_CASE = (4, 1024, 1024, 24, 2, 128, True, 0)
LOCAL_TRAIN_CASE = (2, 3000, 3000, 16, 1, 256, True, 2048)
PALI_TRAIN_CASE = (4, 768, 768, 8, 1, 256, True, 0)
BWD_TC_CASES = [
    ((1, 100, 100, 4, 4, 64, True, 0), 1),
    ((2, 70, 90, 6, 2, 32, True, 0), 3),
    ((1, 40, 24, 12, 4, 64, True, 0), 3),
    ((1, 130, 130, 12, 1, 128, True, 48), 12),
    ((1, 200, 150, 12, 1, 32, False, 0), 12),
    ((4, 1024, 1024, 12, 4, 64, True, 0), 2),
    (TRAIN_CASE, 4),
    ((1, 256, 256, 16, 1, 256, True, 0), 16),
    ((1, 300, 300, 16, 1, 256, True, 64), 16),
    ((2, 40, 24, 4, 2, 256, True, 0), 2),
    ((1, 33, 90, 16, 1, 256, False, 0), 16),
    ((1, 130, 200, 4, 2, 256, True, 48), 2),
    ((4, 700, 700, 16, 1, 256, True, 0), 6),
    (LOCAL_TRAIN_CASE, 3),
    # Head dim 64 non-causal with T != S (whisper's MHA, one group a KV
    # head), head dim 256 at MQA 8:1 with no window (paligemma), and the
    # new archs' main shapes with their splits (paligemma's G = 6 over its
    # group of 8).
    ((2, 70, 130, 12, 12, 64, False, 0), 1),
    ((1, 150, 90, 4, 2, 64, False, 0), 2),
    ((1, 256, 256, 8, 1, 256, True, 0), 8),
    ((4, 1500, 1500, 12, 12, 64, False, 0), 1),
    ((4, 448, 1500, 12, 12, 64, False, 0), 1),
    ((4, 768, 768, 8, 1, 256, True, 0), 6),
    ((4, 1024, 1024, 16, 8, 64, True, 0), 1),
    ((4, 1024, 1024, 32, 8, 128, True, 0), 1),
]
# The wgmma backward's tiles (head dims 64 and 128: dK/dV 128 keys a block
# and 128 or 64 queries a stage, dQ 128 rows a block and 128 keys a stage;
# head dim 256: dK/dV 64 keys a block and 64 queries a stage, dQ 128 rows a
# block and 64 keys a stage), with the split G the kernels take at each
# shape: T and S ragged against all of them, T > S so that rows see no key,
# a window of 200 that leaves whole stages unseen, non-causal T != S;
# granite's GQA 2:1 at D=64 and phi3.5's 4:1 at D=128.
# tests/test_torch_attn_tc.py holds its CPU emulation of the kernels'
# rounding on the same cases.
WGMMA_BWD_CASES = [case for D in (64, 128, 256) for case in (
    ((1, 200, 330, 4, 2, D, True, 0), 2),
    ((1, 300, 140, 4, 1, D, True, 0), 4),
    ((1, 640, 640, 4, 2, D, True, 200), 2),
    ((2, 150, 400, 4, 2, D, False, 0), 2),
)] + [((1, 256, 256, 16, 8, 64, True, 0), 2), ((1, 256, 256, 32, 8, 128, True, 0), 4)]
BWD_TC_CASES += WGMMA_BWD_CASES


def _bwd_vs_plain(case, dtype, seed):
    """(dq, dk, dv) through the kernels and through f32 autograd of plain."""
    B, T, S, H, K, D, causal, window = case
    rng = np.random.default_rng(seed)
    q, k, v = (_cuda(rng, shape, dtype).requires_grad_()
               for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))
    dout = _cuda(rng, (B, T, H, D), dtype)
    got = torch.autograd.grad(
        ops.flash_attention(q, k, v, causal=causal, window=window), (q, k, v), dout)
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(
        ref.attention_ref(qf, kf, vf, causal=causal, window=window),
        (qf, kf, vf), dout.float())
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("case,groups", BWD_TC_CASES, ids=str)
def test_flash_attention_bwd_tensor_cores_vs_autograd_of_plain(case, groups):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, S, H, K, D, causal, window = case
    assert fa.bwd_path(torch.bfloat16, D) == (2 if D in fa.WGMMA_BWD_TILES else 1)
    assert fa.bwd_groups(B, S, H, K, D) == groups
    before = fa.BWD_LAUNCHES
    got, want = _bwd_vs_plain(case, torch.bfloat16, 12)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        _close(g, w, TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("case", [TRAIN_CASE, (4, 1024, 1024, 12, 4, 64, True, 0),
                                  LOCAL_TRAIN_CASE, PALI_TRAIN_CASE], ids=str)
def test_flash_attention_bwd_is_deterministic(case):
    """No atomics: two backward calls on the same inputs agree bit for bit
    (G = 4 at the training shape; G = 2 over a group of 3; G = 3 at
    recurrentgemma's local training shape and G = 6 at paligemma's, head
    dim 256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, S, H, K, D, causal, window = case
    rng = np.random.default_rng(13)
    q, k, v = (_cuda(rng, shape, torch.bfloat16)
               for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))
    dout = _cuda(rng, (B, T, H, D), torch.bfloat16)
    o, lse, o_lo = fa._forward(q, k, v, causal, window, D ** -0.5, with_lse=True)
    first, second = (fa.flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal=causal,
                                                 window=window, o_lo=o_lo)
                     for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_flash_attention_paths():
    """The bf16 forward and backward take the wgmma kernels at head dims 64,
    128 and 256 and the mma.sync kernels at 16 and 32; f32,
    head dims the tensor-core kernels do not instantiate, and unaligned
    pointers take the FMA kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bf16, f32 = torch.bfloat16, torch.float32
    assert [fa.fwd_path(bf16, D) for D in (16, 32, 64, 128, 256)] == [1, 1, 2, 2, 2]
    assert fa.PATHS[2] == "wgmma"
    assert [fa.bwd_path(bf16, D) for D in (16, 32, 64, 128)] == [1, 1, 2, 2]
    assert fa.bwd_path(bf16, 256) == 2
    assert fa.fwd_path(bf16, 96) == fa.bwd_path(bf16, 96) == 0
    assert fa.fwd_path(f32, 128) == fa.bwd_path(f32, 128) == 0
    assert fa.fwd_path(f32, 256) == fa.bwd_path(f32, 256) == 0
    assert fa.fwd_path(bf16, 128, aligned=False) == 0
    assert fa.bwd_path(bf16, 128, aligned=False) == 0
    assert fa.bwd_path(bf16, 256, aligned=False) == 0


@pytest.mark.gpu
def test_flash_attention_unaligned_bf16_takes_fma_path_and_agrees():
    """q 2 bytes past a 16-byte boundary: the forward and backward fall to
    the FMA kernels, which still match plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    case = (1, 50, 50, 4, 2, 128, True, 0)
    B, T, S, H, K, D, causal, window = case
    rng = np.random.default_rng(14)
    flat = _cuda(rng, (B * T * H * D + 1,), torch.bfloat16)
    q = flat[1:].view(B, T, H, D).requires_grad_()
    assert q.data_ptr() % 16 != 0
    k, v = (_cuda(rng, (B, S, K, D), torch.bfloat16).requires_grad_() for _ in range(2))
    dout = _cuda(rng, (B, T, H, D), torch.bfloat16)
    got = torch.autograd.grad(
        fa.flash_attention_cuda(q, k, v, causal=causal), (q, k, v), dout)
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    want_o = ref.attention_ref(qf, kf, vf, causal=causal)
    want = torch.autograd.grad(want_o, (qf, kf, vf), dout.float())
    with torch.no_grad():
        _close(fa.flash_attention_cuda(q, k, v, causal=causal), want_o, 2e-2)
    for g, w in zip(got, want):
        _close(g, w, 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_bwd_rows_that_see_no_key_get_zero_grads(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(8)
    q, k, v = (_cuda(rng, shape, dtype).requires_grad_()
               for shape in ((1, 40, 4, 64), (1, 8, 2, 64), (1, 8, 2, 64)))
    out = ops.flash_attention(q, k, v, causal=True)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert bool(torch.isfinite(dq).all() & torch.isfinite(dk).all()
                & torch.isfinite(dv).all())
    assert bool((dq[:, :32] == 0).all())        # rows t < T-S see no key


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES + D256_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_serving_unchanged_by_lse(case, dtype):
    """The forward that writes the log-sum-exp gives the same bits as the
    serving forward, and its lse is the plain one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, S, H, K, D, causal, window = case
    rng = np.random.default_rng(9)
    q, k, v = (_cuda(rng, shape, dtype)
               for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))
    scale = D ** -0.5
    plain_out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    out, lse, o_lo = fa._forward(q, k, v, causal, window, scale, with_lse=True)
    assert torch.equal(out, plain_out)
    # o + o_lo is the f32 result: o_lo is what rounding it to o lost.
    if dtype == torch.bfloat16:
        assert bool((o_lo.float().abs() <= out.float().abs() * 2 ** -8).all())
        assert bool(o_lo.abs().sum() > 0)
    want, seen = _plain_lse(q, k, causal, window)
    assert bool((lse[~seen] == float("-inf")).all())
    _close(lse[seen], want[seen], 1e-4)


def _plain_lse(q, k, causal, window):
    """Each row's log-sum-exp of its scaled, masked scores in f32, (B,H,T),
    and which rows see a key (the others' log-sum-exp is -inf)."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // K, 2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * D ** -0.5
    qpos = torch.arange(T, device=q.device)[:, None] + (S - T)
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1)
    return lse, mask.any(-1).expand_as(lse)


# The wgmma forward's tiles (128 query rows; 128 keys at head dims 64 and
# 128, 64 keys at 256): T and S ragged against both, T > S so that rows see
# no key, a window of 200 that leaves whole KV tiles unseen by a query tile,
# llama3's and recurrentgemma's GQA 16:1, and non-causal with T != S.
# tests/test_torch_attn_tc.py holds its CPU emulation of the kernel's
# rounding on the same cases.
WGMMA_FWD_CASES = [case for D in (64, 128, 256) for case in (
    (1, 200, 330, 4, 2, D, True, 0),
    (1, 300, 140, 4, 1, D, True, 0),
    (1, 640, 640, 4, 2, D, True, 200),
    (1, 256, 256, 16, 1, D, True, 0),
    (2, 150, 400, 4, 2, D, False, 0),
)]
# Those, then the main paths' shapes: qwen3-32b prefill, starcoder2-3b
# training, whisper-small's encoder and cross-attention, llama3-405b
# prefill, phi3.5-moe and granite-moe prefill; at head dim 256 paligemma-3b's
# training shape and recurrentgemma-9b's local serving and training shapes.
WGMMA_CASES = WGMMA_FWD_CASES + [
    (4, 1024, 1024, 64, 8, 128, True, 0),
    (4, 1024, 1024, 24, 2, 128, True, 0),
    (4, 1500, 1500, 12, 12, 64, False, 0),
    (4, 448, 1500, 12, 12, 64, False, 0),
    (4, 1024, 1024, 128, 8, 128, True, 0),
    (4, 1024, 1024, 32, 8, 128, True, 0),
    (4, 1024, 1024, 16, 8, 64, True, 0),
    (4, 768, 768, 8, 1, 256, True, 0),
    (4, 3000, 3000, 16, 1, 256, True, 2048),
    (2, 3000, 3000, 16, 1, 256, True, 2048),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
def test_flash_attention_wgmma_vs_plain(case):
    """Path 2 against plain: o at 2e-2; lse against a plain logsumexp at
    1e-4 and -inf on rows that see no key; o + o_lo, the f32 result, at
    2e-2 with o_lo within bf16's rounding of o; o bit-equal with and
    without lse, and all three bit-equal on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, S, H, K, D, causal, window = case
    rng = np.random.default_rng(15)
    q, k, v = (_cuda(rng, shape, torch.bfloat16)
               for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))
    assert fa.fwd_path(q.dtype, D, fa._aligned(q, k, v)) == 2
    before = fa.LAUNCHES
    serve_out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    first = fa._forward(q, k, v, causal, window, D ** -0.5, with_lse=True)
    second = fa._forward(q, k, v, causal, window, D ** -0.5, with_lse=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 3
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    out, lse, o_lo = first
    assert torch.equal(out, serve_out)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal,
                             window=window)
    _close(out, want, 2e-2)
    _close(out.float() + o_lo.float(), want, 2e-2)
    assert bool((o_lo.float().abs() <= out.float().abs() * 2 ** -8).all())
    want_lse, seen = _plain_lse(q, k, causal, window)
    assert bool((lse[~seen] == float("-inf")).all())
    assert bool((out.transpose(1, 2)[~seen] == 0).all())
    _close(lse[seen], want_lse[seen], 1e-4)


# The scans' backward kernels against autograd of the plain scans in f32, on
# the same inputs and cotangents.  Tolerances: gradients of one element each
# (dx, ddt, da_gate, di_gate, dh0) at atol = rtol = 1e-4, the forward's f32
# tolerance, since each is a short chain of f32 operations in another order
# than autograd's (and the kernels' exponentials are ex2.approx, about 2^-22
# relative); gradients summed over the batch and time or over the channels
# (dA, dD, dB, dC, dlog_lam) by the relative norm of their error, <= 1e-4,
# since a sum of thousands of terms of both signs can cancel to near zero,
# where an elementwise relative bound says nothing.  bf16 inputs are held
# within 2e-2 (the bf16 output tolerance) of f32 autograd of plain on their
# upcast values: the kernel reads bf16 and computes in f32, and rounds dx,
# da_gate, di_gate to bf16 once.
def _grads_vs_plain(run, plain, ins, cots, dtype, summed, names):
    """(kernel grads, plain f32 grads) of sum(out * cot) over both outputs,
    and the checks above."""
    ins = [None if t is None else t.clone().requires_grad_() for t in ins]
    outs = run(*ins)
    loss = sum((o.float() * c.float()).sum() for o, c in zip(outs, cots)
               if c is not None)
    live = [t for t in ins if t is not None]
    got = torch.autograd.grad(loss, live)
    insf = [None if t is None else t.detach().float().requires_grad_() for t in ins]
    outs = plain(*insf)
    loss = sum((o * c.float()).sum() for o, c in zip(outs, cots) if c is not None)
    want = torch.autograd.grad(loss, [t for t in insf if t is not None])
    tol = TOL[dtype]
    for name, g, w in zip([n for n, t in zip(names, ins) if t is not None],
                          got, want):
        assert g.dtype == dict(zip(names, ins))[name].dtype, name
        if name in summed:
            err = ((g.float() - w).norm() / w.norm().clamp(min=1e-30)).item()
            assert err <= (1e-4 if dtype == torch.float32 else tol), (name, err)
        else:
            np.testing.assert_allclose(g.float().cpu().numpy(), w.cpu().numpy(),
                                       atol=tol, rtol=tol, err_msg=name)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("with_dhT", [False, True], ids=["dhT=0", "dhT"])
def test_ssm_scan_bwd_cuda_vs_autograd_of_plain(case, dtype, with_h0, with_dhT):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Bt, T, I, N = case
    rng = np.random.default_rng(11)
    x = _cuda(rng, (Bt, T, I), dtype)
    dt = torch.nn.functional.softplus(_cuda(rng, (Bt, T, I)))
    A = -torch.exp(_cuda(rng, (I, N)))
    Bm, Cm = _cuda(rng, (Bt, T, N), dtype), _cuda(rng, (Bt, T, N), dtype)
    D = _cuda(rng, (I,))
    h0 = _cuda(rng, (Bt, I, N)) if with_h0 else None
    cots = (_cuda(rng, (Bt, T, I), dtype), _cuda(rng, (Bt, I, N)) if with_dhT else None)
    before = ss.BWD_LAUNCHES
    _grads_vs_plain(ops.ssm_scan, ref.ssm_scan_ref, (x, dt, A, Bm, Cm, D, h0),
                    cots, dtype, ("A", "B", "C", "D"),
                    ("x", "dt", "A", "B", "C", "D", "h0"))
    assert ss.BWD_LAUNCHES == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", RGLRU_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("with_dhT", [False, True], ids=["dhT=0", "dhT"])
def test_rglru_scan_bwd_cuda_vs_autograd_of_plain(case, dtype, with_h0, with_dhT):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, L = case
    rng = np.random.default_rng(12)
    x, a, i = (_cuda(rng, (B, T, L), dtype) for _ in range(3))
    lam = _cuda(rng, (L,))
    h0 = _cuda(rng, (B, L)) if with_h0 else None
    cots = (_cuda(rng, (B, T, L), dtype), _cuda(rng, (B, L)) if with_dhT else None)
    before = rs.BWD_LAUNCHES
    _grads_vs_plain(ops.rglru, ref.rglru_ref, (x, a, i, lam, h0), cots, dtype,
                    ("log_lam",), ("x", "a_gate", "i_gate", "log_lam", "h0"))
    assert rs.BWD_LAUNCHES == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["ssm_scan", "rglru_scan"])
def test_scan_backward_kernels_are_deterministic_at_the_training_shapes(kernel):
    """No atomics: two backward calls at the training shapes (falcon-mamba-7b
    B=4 T=1024, recurrentgemma-9b B=2 T=3000, bf16) give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(13)
    if kernel == "ssm_scan":
        Bt, T, I, N = 4, 1024, 8192, 16
        args = ss._prepare(_cuda(rng, (Bt, T, I), torch.bfloat16),
                           torch.nn.functional.softplus(_cuda(rng, (Bt, T, I))),
                           -torch.exp(_cuda(rng, (I, N))),
                           _cuda(rng, (Bt, T, N), torch.bfloat16),
                           _cuda(rng, (Bt, T, N), torch.bfloat16),
                           _cuda(rng, (I,)), None)
        _, _, carries = ss._forward(*args, save=True)
        dy = _cuda(rng, (Bt, T, I), torch.bfloat16)
        first, second = (ss.ssm_scan_bwd_cuda(dy, None, *args[:6], carries)
                         for _ in range(2))
    else:
        B, T, L = 2, 3000, 4096
        args = rs._prepare(*(_cuda(rng, (B, T, L), torch.bfloat16) for _ in range(3)),
                           _cuda(rng, (L,)), None)
        _, _, carries = rs._forward(*args, 8.0, save=True)
        dh = _cuda(rng, (B, T, L), torch.bfloat16)
        first, second = (rs.rglru_scan_bwd_cuda(dh, None, *args[:4], carries)
                         for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# The backward kernels' own tiles (ss.BWD_SEGMENT = 8 steps, 8 lanes, 64
# channels, states in pairs; rs.BWD_SEGMENT = 4 steps, 16 lanes, 32
# channels): odd N (a pair with a zero state), T not a multiple of the
# 64-step chunk with the last chunk ending inside a segment, and channel
# counts that leave a ragged channel block on the plain-load route (33, 71)
# and on the cp.async route (72, 136).
SSM_BWD_EDGES = [(2, ss.BWD_SEGMENT - 1, 33, 1), (1, ss.CHUNK + ss.BWD_SEGMENT + 1, 72, 3),
                 (2, 2 * ss.CHUNK + 5, 71, 5), (3, 3 * ss.CHUNK - 1, 136, 7),
                 (1, 130, 40, 9), (2, 77, 96, 15)]
RGLRU_BWD_EDGES = [(2, rs.BWD_SEGMENT - 1, 33), (1, rs.CHUNK + rs.BWD_SEGMENT + 1, 72),
                   (2, 2 * rs.CHUNK + 5, 71), (3, 3 * rs.CHUNK - 1, 136)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSM_BWD_EDGES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_dhT", [False, True], ids=["dhT=0", "dhT"])
def test_ssm_scan_bwd_at_the_backward_tile_edges(case, dtype, with_dhT):
    """The selective-scan backward at its own tile edges against autograd
    of plain (tolerances as above), and the same bits on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Bt, T, I, N = case
    rng = np.random.default_rng(15)
    x = _cuda(rng, (Bt, T, I), dtype)
    dt = torch.nn.functional.softplus(_cuda(rng, (Bt, T, I)))
    A = -torch.exp(_cuda(rng, (I, N)))
    Bm, Cm = _cuda(rng, (Bt, T, N), dtype), _cuda(rng, (Bt, T, N), dtype)
    D, h0 = _cuda(rng, (I,)), _cuda(rng, (Bt, I, N))
    cots = (_cuda(rng, (Bt, T, I), dtype), _cuda(rng, (Bt, I, N)) if with_dhT else None)
    first, second = (_grads_vs_plain(ops.ssm_scan, ref.ssm_scan_ref,
                                     (x, dt, A, Bm, Cm, D, h0), cots, dtype,
                                     ("A", "B", "C", "D"),
                                     ("x", "dt", "A", "B", "C", "D", "h0"))
                     for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("case", RGLRU_BWD_EDGES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_dhT", [False, True], ids=["dhT=0", "dhT"])
def test_rglru_scan_bwd_at_the_backward_tile_edges(case, dtype, with_dhT):
    """The RG-LRU backward at its own tile edges against autograd of plain
    (tolerances as above), and the same bits on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, L = case
    rng = np.random.default_rng(16)
    x, a, i = (_cuda(rng, (B, T, L), dtype) for _ in range(3))
    lam, h0 = _cuda(rng, (L,)), _cuda(rng, (B, L))
    cots = (_cuda(rng, (B, T, L), dtype), _cuda(rng, (B, L)) if with_dhT else None)
    first, second = (_grads_vs_plain(ops.rglru, ref.rglru_ref, (x, a, i, lam, h0), cots,
                                     dtype, ("log_lam",),
                                     ("x", "a_gate", "i_gate", "log_lam", "h0"))
                     for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_scan_forward_with_carries_equals_without():
    """The carries output changes nothing else: y and h_T are the same bits
    with and without it, and the carries are the states entering each
    chunk (chunk 0's is h0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(14)
    Bt, T, I, N = 2, 3 * ss.CHUNK + 5, 72, 16
    args = ss._prepare(_cuda(rng, (Bt, T, I), torch.bfloat16),
                       torch.nn.functional.softplus(_cuda(rng, (Bt, T, I))),
                       -torch.exp(_cuda(rng, (I, N))), _cuda(rng, (Bt, T, N)),
                       _cuda(rng, (Bt, T, N)), _cuda(rng, (I,)),
                       _cuda(rng, (Bt, I, N)))
    y0, h0, none = ss._forward(*args, save=False)
    y1, h1, carries = ss._forward(*args, save=True)
    assert none is None and torch.equal(y0, y1) and torch.equal(h0, h1)
    assert torch.equal(carries[:, 0], args[6])
    _, h_first = ss._forward(*((args[0][:, :ss.CHUNK].contiguous(),
                                args[1][:, :ss.CHUNK].contiguous(), args[2],
                                args[3][:, :ss.CHUNK].contiguous(),
                                args[4][:, :ss.CHUNK].contiguous()) + args[5:]),
                             save=False)[:2]
    torch.testing.assert_close(carries[:, 1], h_first, atol=1e-5, rtol=1e-5)
    B, T, L = 2, 2 * rs.CHUNK + 9, 136
    args = rs._prepare(*(_cuda(rng, (B, T, L)) for _ in range(3)),
                       _cuda(rng, (L,)), _cuda(rng, (B, L)))
    y0, h0, none = rs._forward(*args, 8.0, save=False)
    y1, h1, carries = rs._forward(*args, 8.0, save=True)
    assert none is None and torch.equal(y0, y1) and torch.equal(h0, h1)
    assert torch.equal(carries[:, 0], args[4])
    torch.testing.assert_close(carries[:, 1], y1[:, rs.CHUNK - 1].float(),
                               atol=1e-5, rtol=1e-5)


def _tie_rows(C):
    """Rows whose codes hit exact .5 ties: amax 127 (scale 1) and 254
    (scale 2), with halves of both parities."""
    halves = np.arange(C, dtype=np.float32) % 8 - 3.5
    r1 = halves.copy()
    r1[0] = 127.0
    r2 = 2 * halves
    r2[-1] = -254.0
    return np.stack([r1, r2, -r1])


def _quant_input(name):
    rng = np.random.default_rng(11)
    if name == "ties":
        return _tie_rows(64)
    if name == "zero-row":
        x = 3 * rng.standard_normal((4, 40), dtype=np.float32)
        x[2] = 0.0
        return x
    return 3 * rng.standard_normal(name, dtype=np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [(8, 16), (7, 33), (128, 256), (1, 5),
                                  "ties", "zero-row", (36864, 1024)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantize_cuda_vs_plain(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.from_numpy(_quant_input(name)).to(dtype).cuda()
    before = qz.LAUNCHES
    q, s = ops.quantize(x)
    torch.cuda.synchronize()
    assert qz.LAUNCHES == before + 1
    q_ref, s_ref = ref.quantize_ref(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (x.shape[0], 1)
    assert torch.equal(q, q_ref)
    _close(s, s_ref, 1e-6)


# The fused AdamW update against the slice loop, bit for bit: (p, g, moments)
# dtypes as the port uses them (bf16 weights with f32 moments, f32 weights,
# f32 gradients of M > 1 microbatches on bf16 weights, llama3-405b's bf16
# moments); leaves shorter than a vector, ragged against the 8-element
# vectors, and over one 2^26 slice of the loop.
ADAMW_DTYPES = [(torch.bfloat16, torch.bfloat16, torch.float32),
                (torch.float32, torch.float32, torch.float32),
                (torch.bfloat16, torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16, torch.bfloat16)]
ADAMW_DTYPE_IDS = ["bf16-bf16-f32", "f32-f32-f32", "bf16-f32-f32", "bf16-bf16-bf16"]
ADAMW_HYPER = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _adamw_leaf(n, dtypes, seed, offsets=(0, 0, 0, 0)):
    """p, g, m, v of n elements, each starting ``offsets`` elements into its
    allocation; v positive, as a second moment is."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for dtype, off, scale, square in zip((dtypes[0], dtypes[1], dtypes[2], dtypes[2]),
                                         offsets, (1.0, 1.0, 0.1, 0.1),
                                         (False, False, False, True)):
        x = torch.randn(n + off, generator=gen, device="cuda") * scale
        out.append((x * x if square else x).to(dtype)[off:])
    return out


def _adamw_scalars(clip, step):
    """clip, bc1, bc2 as adamw_update makes them on the card."""
    f32 = dict(dtype=torch.float32, device="cuda")
    stepf = torch.tensor(step, dtype=torch.int32, device="cuda").float()
    return (torch.tensor(clip, **f32),
            1 - torch.tensor(ADAMW_HYPER["b1"], **f32) ** stepf,
            1 - torch.tensor(ADAMW_HYPER["b2"], **f32) ** stepf)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _adamw_kernel_vs_slices(leaf, clip, step, decay):
    plain = [t.clone() for t in leaf]
    scalars = _adamw_scalars(clip, step)
    before = (AK.LAUNCHES, AK.ELEMENTS)
    versions = [t._version for t in leaf]
    AK.adamw_cuda(*leaf, *scalars, **ADAMW_HYPER, decay=decay)
    TO.update_in_slices(*plain, *scalars, **ADAMW_HYPER, decay=decay)
    torch.cuda.synchronize()
    n = leaf[0].numel()
    assert (AK.LAUNCHES, AK.ELEMENTS) == (before[0] + 1, before[1] + n)
    # p, m and v were written in place, and autograd is told so; g was not.
    assert [t._version > v0 for t, v0 in zip(leaf, versions)] == [True, False, True, True]
    for name, got, want in zip("pgmv", leaf, plain):
        assert torch.equal(_bits(got), _bits(want)), name


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 4097, (1 << 26) + 3])
@pytest.mark.parametrize("dtypes", ADAMW_DTYPES, ids=ADAMW_DTYPE_IDS)
@pytest.mark.parametrize("decay", [False, True], ids=["no-decay", "decay"])
@pytest.mark.parametrize("clip", [1.0, 0.37], ids=["clip-off", "clip-on"])
@pytest.mark.parametrize("step", [1, 2])
def test_adamw_kernel_equals_the_slice_loop(n, dtypes, decay, clip, step):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _adamw_kernel_vs_slices(_adamw_leaf(n, dtypes, seed=n + step), clip, step, decay)


@pytest.mark.gpu
@pytest.mark.parametrize("offsets", [(1, 1, 1, 1), (1, 0, 3, 2)], ids=["same", "mixed"])
@pytest.mark.parametrize("dtypes", ADAMW_DTYPES, ids=ADAMW_DTYPE_IDS)
def test_adamw_kernel_at_unaligned_offsets(offsets, dtypes):
    """A leaf that starts off the 16-byte boundary: the same offset in all
    four tensors (a head element by element, then vectors), or offsets no
    common start aligns (the whole leaf element by element)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    leaf = _adamw_leaf(4097, dtypes, seed=9, offsets=offsets)
    assert leaf[0].data_ptr() % 16 != 0
    _adamw_kernel_vs_slices(leaf, 0.37, 2, True)


def _adamw_tree(dtypes, seed):
    shapes = {"w": (64, 33), "b": (33,), "t": (3, 5, 7), "s": (1,), "e": (0, 4)}
    params, grads, m, v = ({} for _ in range(4))
    for i, (name, shape) in enumerate(shapes.items()):
        n = int(np.prod(shape))
        leaf = _adamw_leaf(n, dtypes, seed=seed + i)
        for tree, t in zip((params, grads, m, v), leaf):
            tree[name] = t.reshape(shape)
    return params, grads, {"m": m, "v": v,
                           "step": torch.ones((), dtype=torch.int32, device="cuda")}


@pytest.mark.gpu
def test_adamw_update_launches_once_per_nonempty_leaf():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params, grads, state = _adamw_tree(ADAMW_DTYPES[0], seed=11)
    before = (AK.LAUNCHES, AK.ELEMENTS)
    TO.adamw_update(grads, state, params, TO.AdamWConfig())
    torch.cuda.synchronize()
    nonempty = [p for p in params.values() if p.numel()]
    assert AK.LAUNCHES == before[0] + len(nonempty) == before[0] + 4
    assert AK.ELEMENTS == before[1] + sum(p.numel() for p in nonempty)


@pytest.mark.gpu
def test_adamw_kernel_launches_without_a_host_sync():
    """Every leaf's launch runs under sync debug mode "error": clip and the
    bias corrections are read on the card, nothing comes back to the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params, grads, state = _adamw_tree(ADAMW_DTYPES[0], seed=12)
    scalars = _adamw_scalars(0.5, 3)
    AK._fn()                             # the build and load, before the mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, p in params.items():
            AK.adamw_cuda(p, grads[name], state["m"][name], state["v"][name],
                          *scalars, **ADAMW_HYPER, decay=p.ndim >= 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 2])
def test_train_steps_with_the_adamw_kernel_equal_the_slice_loop(M, monkeypatch):
    """Two train steps of starcoder2's TINY config (bf16 weights, f32
    moments; f32 gradients when M = 2) on the card: the same parameters and
    moments through the kernel as through the slice loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs.registry import tiny_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.train.train_step import make_train_step, train_state_init
    cfg = tiny_config("starcoder2-3b")
    opt = TO.AdamWConfig(lr=1e-2)
    runs = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(ops, "adamw", TO.update_in_slices)
        state = train_state_init(torch.Generator(device="cuda").manual_seed(3),
                                 cfg, opt, "cuda")
        step = make_train_step(cfg, opt, num_microbatches=M)
        before = (AK.LAUNCHES, AK.ELEMENTS)
        for seed in (4, 5):
            state, _ = step(state, synthetic_batch(seed, cfg, 4, 32, "cuda"))
        torch.cuda.synchronize()
        params = dict(state["params"].named_parameters())
        if fused:
            assert AK.LAUNCHES == before[0] + 2 * len(params)
            assert AK.ELEMENTS == before[1] + 2 * sum(p.numel() for p in params.values())
        runs.append((params, state["opt"]))
    (pa, oa), (pb, ob) = runs
    for n in pa:
        assert torch.equal(_bits(pa[n].detach()), _bits(pb[n].detach())), n
        for mom in ("m", "v"):
            assert torch.equal(_bits(oa[mom][n]), _bits(ob[mom][n])), (mom, n)


# The norm kernels against the plain chain (ref.norm_ref) and autograd
# through it: widths of Jamba's B/C (16) and dt (160) norms, a qk-norm head
# (128), whisper-small (768), Jamba (2560), starcoder2 (3072), phi3.5 (4096)
# and llama3-405b (16384), over an odd number of rows.  Tolerances:
# f32 1e-5, since the two differ only in the order of each row's f32 sums;
# bf16 2e-2, since a value next to a rounding point of bf16 may round the
# other way (one ulp, 2^-8 relative).  dscale and dbias, sums over every
# row, by the norm of their error over the plain's norm, at the same
# tolerances.  A second backward gives the same bits.
NORM_WIDTHS = [16, 128, 160, 768, 2560, 3072, 4096, 16384]
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
NORM_ROWS = 1037


def _norm_inputs(shape, dtype, kind, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    C = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    scale = 1 + 0.1 * torch.randn(C, generator=gen, device="cuda")
    bias = (0.1 * torch.randn(C, generator=gen, device="cuda")
            if kind == "layernorm" else None)
    return x, scale, bias


def _norm_grads(fn, base, view, scale, bias, dy):
    """y = fn(view(base), scale, bias) and the gradients of <y, dy> with
    respect to base, scale and bias (fresh leaves; a view of base keeps its
    strides)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (base, scale, bias)
              if t is not None]
    y = fn(view(leaves[0]), *leaves[1:], *([None] if bias is None else []))
    return y.detach(), torch.autograd.grad(y, leaves, dy)


def _norm_vs_plain(base, view, scale, bias, kind, dtype):
    """Forward, dx, dscale and dbias of the kernels on view(base) against
    the plain chain's; the launches counted; a second backward's bits
    equal."""
    from repro_torch.kernels import norm as NK
    dy = _norm_inputs(view(base).shape, dtype, "rmsnorm", seed=99)[0]
    before = (NK.LAUNCHES, NK.BWD_LAUNCHES)

    def kernels(a, s, b):
        return ops.norm(a, s, b, kind)

    y, grads = _norm_grads(kernels, base, view, scale, bias, dy)
    torch.cuda.synchronize()
    assert (NK.LAUNCHES, NK.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    y_ref, grads_ref = _norm_grads(lambda a, s, b: ref.norm_ref(a, s, b, kind),
                                   base, view, scale, bias, dy)
    tol = NORM_TOL[dtype]
    assert y.dtype == dtype and grads[0].dtype == dtype
    _close(y, y_ref, tol)
    _close(grads[0], grads_ref[0], tol)
    for g, want in zip(grads[1:], grads_ref[1:]):
        assert g.dtype == torch.float32
        err = float((g - want).norm() / want.norm().clamp_min(1e-30))
        assert err <= tol, err
    _, again = _norm_grads(kernels, base, view, scale, bias, dy)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(grads, again))


@pytest.mark.gpu
@pytest.mark.parametrize("width", NORM_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_kernels_vs_plain(width, dtype, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, scale, bias = _norm_inputs((NORM_ROWS, width), dtype, kind, seed=width)
    _norm_vs_plain(x, lambda t: t, scale, bias, kind, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [(0, 160), (160, 176), (176, 192), (1, 25), (3, 27)],
                         ids=["dt", "B", "C", "unaligned", "unaligned-odd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_norm_kernels_on_strided_rows(cols, dtype):
    """Views of a (B, T, 192) projection, as Jamba's x_proj split gives its
    dt, B and C (read in place), and views at unaligned offsets with widths
    that leave a tail (read element by element), under RMSNorm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import norm as NK
    lo, hi = cols
    proj = _norm_inputs((3, 345, 192), dtype, "rmsnorm", seed=lo)[0]
    scale = _norm_inputs((hi - lo,), torch.float32, "rmsnorm", seed=hi)[1]
    assert NK.row_stride(proj[..., lo:hi]) == 192
    _norm_vs_plain(proj, lambda t: t[..., lo:hi], scale, None, "rmsnorm", dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_kernel_on_the_last_position(kind):
    """Prefill's final norm of ``x[:, -1:]``: rows a sequence apart, read in
    place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, scale, bias = _norm_inputs((3, 77, 3072), torch.bfloat16, kind, seed=5)
    _norm_vs_plain(x, lambda t: t[:, -1:], scale, bias, kind, torch.bfloat16)

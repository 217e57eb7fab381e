"""Port recurrences (selective scan, RG-LRU) against the JAX reference.

The plain PyTorch scans (the CPU route of ``ops.ssm_scan`` and ``ops.rglru``)
are held against ``repro.kernels.ref``, the chunked ``repro.kernels.ops``
and the Pallas kernels run in interpret mode, over the reference's
SSM_CASES / RGLRU_CASES and beyond, at the reference's tolerance (1e-4; bf16
outputs 2e-2).  The one-token decode steps are held against the reference's
and against the scans.  The CUDA kernels run only on a card: their tests are
in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_pallas  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan_cuda  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_cuda  # noqa: E402

SSM_CASES = [(1, 8, 4, 2), (2, 16, 8, 4), (1, 24, 6, 3)]   # B, T, I, N
RGLRU_CASES = [(1, 8, 4), (2, 16, 8), (1, 13, 6)]          # B, T, L
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
TOL = dict(atol=1e-4, rtol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _ssm_inputs(seed, B, T, I, N):
    r = _rng(seed)
    n = lambda *s: r.standard_normal(s, dtype=np.float32)   # noqa: E731
    return dict(x=n(B, T, I), dt=np.log1p(np.exp(n(B, T, I))),
                A=-np.exp(n(I, N)), B=n(B, T, N), C=n(B, T, N), D=n(I),
                h0=n(B, I, N))


def _rglru_inputs(seed, B, T, L):
    r = _rng(seed)
    n = lambda *s: r.standard_normal(s, dtype=np.float32)   # noqa: E731
    return dict(x=n(B, T, L), a=n(B, T, L), i=n(B, T, L), lam=n(L), h0=n(B, L))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# --------------------------------------------------------------------------
# selective scan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", SSM_CASES)
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
def test_ssm_scan_plain_vs_reference(case, dt_name, with_h0):
    jdt, tdt, tol = DTYPES[dt_name]
    a = _ssm_inputs(0, *case)
    h0 = a["h0"] if with_h0 else None
    jy, jh = jref.ssm_scan_ref(
        jnp.asarray(a["x"]).astype(jdt),
        *(jnp.asarray(a[k]) for k in "dt A B C D".split()),
        None if h0 is None else jnp.asarray(h0))
    args = (_t(a["x"], tdt), _t(a["dt"]), _t(a["A"]), _t(a["B"]), _t(a["C"]),
            _t(a["D"]), None if h0 is None else _t(h0))
    y, h = ops.ssm_scan(*args)
    assert y.dtype == tdt and h.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)
    # ops.ssm_scan on a CPU tensor is the plain version.
    yr, hr = ref.ssm_scan_ref(*args)
    np.testing.assert_array_equal(_np(y), _np(yr))
    np.testing.assert_array_equal(_np(h), _np(hr))


@pytest.mark.parametrize("case", SSM_CASES)
def test_ssm_scan_plain_vs_pallas_interpret(case):
    a = _ssm_inputs(1, *case)
    jy, jh = ssm_scan_pallas(*(jnp.asarray(a[k]) for k in "x dt A B C D".split()),
                             interpret=True)
    y, h = ops.ssm_scan(*(_t(a[k]) for k in "x dt A B C D".split()))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)


def test_ssm_scan_plain_vs_chunked_reference():
    a = _ssm_inputs(2, 2, 21, 6, 3)          # T not a multiple of the chunk
    keys = "x dt A B C D h0".split()
    jy, jh = jops.ssm_scan(*(jnp.asarray(a[k]) for k in keys), time_chunk=4)
    y, h = ops.ssm_scan(*(_t(a[k]) for k in keys))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)


def test_ssm_step_vs_reference():
    a = _ssm_inputs(3, 2, 1, 5, 3)
    args = [a["x"][:, 0], a["dt"][:, 0], a["A"], a["B"][:, 0], a["C"][:, 0],
            a["D"], a["h0"]]
    jy, jh = jops.ssm_step(*(jnp.asarray(v) for v in args))
    y, h = ops.ssm_step(*(_t(v) for v in args))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)


def test_ssm_step_matches_scan():
    a = _ssm_inputs(4, 2, 6, 4, 3)
    x, dt, A, Bm, C, D = (_t(a[k]) for k in "x dt A B C D".split())
    y_ref, h_ref = ops.ssm_scan(x, dt, A, Bm, C, D)
    h = torch.zeros(2, 4, 3)
    ys = []
    for t in range(x.shape[1]):
        y, h = ops.ssm_step(x[:, t], dt[:, t], A, Bm[:, t], C[:, t], D, h)
        ys.append(y)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(y_ref), **TOL)
    np.testing.assert_allclose(_np(h), _np(h_ref), **TOL)


def test_ssm_h0_seeding():
    """An h0-seeded scan of the tail continues the scan of the head."""
    a = _ssm_inputs(5, 1, 12, 4, 3)
    x, dt, A, Bm, C, D = (_t(a[k]) for k in "x dt A B C D".split())
    full, h_full = ops.ssm_scan(x, dt, A, Bm, C, D)
    head, h_mid = ops.ssm_scan(x[:, :7], dt[:, :7], A, Bm[:, :7], C[:, :7], D)
    tail, h_end = ops.ssm_scan(x[:, 7:], dt[:, 7:], A, Bm[:, 7:], C[:, 7:], D,
                               h0=h_mid)
    np.testing.assert_allclose(_np(torch.cat([head, tail], 1)), _np(full), **TOL)
    np.testing.assert_allclose(_np(h_end), _np(h_full), **TOL)


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", RGLRU_CASES + [(1, 20, 6)])
@pytest.mark.parametrize("dt_name", sorted(DTYPES))
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
def test_rglru_plain_vs_reference(case, dt_name, with_h0):
    jdt, tdt, tol = DTYPES[dt_name]
    a = _rglru_inputs(0, *case)
    h0 = a["h0"] if with_h0 else None
    jx = [jnp.asarray(a[k]).astype(jdt) for k in "x a i".split()]
    jhs, jh = jref.rglru_ref(*jx, jnp.asarray(a["lam"]),
                             None if h0 is None else jnp.asarray(h0))
    args = [_t(a[k], tdt) for k in "x a i".split()] + [
        _t(a["lam"]), None if h0 is None else _t(h0)]
    hs, h = ops.rglru(*args)
    assert hs.dtype == tdt and h.dtype == torch.float32
    np.testing.assert_allclose(_np(hs), _np(jhs), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)
    hr, hTr = ref.rglru_ref(*args)
    np.testing.assert_array_equal(_np(hs), _np(hr))
    np.testing.assert_array_equal(_np(h), _np(hTr))


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
def test_rglru_plain_vs_chunked_reference_at_T20(with_h0):
    """T=20 is not a multiple of the 16-step chunk: the chunked reference
    masks its padded steps, and the port walks exactly T steps."""
    a = _rglru_inputs(1, 2, 20, 6)
    h0 = a["h0"] if with_h0 else None
    jhs, jh = jops.rglru(*(jnp.asarray(a[k]) for k in "x a i lam".split()),
                         None if h0 is None else jnp.asarray(h0), time_chunk=16)
    hs, h = ops.rglru(*(_t(a[k]) for k in "x a i lam".split()),
                      None if h0 is None else _t(h0))
    np.testing.assert_allclose(_np(hs), _np(jhs), **TOL)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)


@pytest.mark.parametrize("case", RGLRU_CASES + [(1, 32, 6)])
def test_rglru_plain_vs_pallas_interpret(case):
    """Only where the Pallas wrapper pads no step: T % 16 == 0 or T <= 16."""
    a = _rglru_inputs(2, *case)
    jhs, jh = rglru_pallas(*(jnp.asarray(a[k]) for k in "x a i lam".split()),
                           interpret=True)
    hs, h = ops.rglru(*(_t(a[k]) for k in "x a i lam".split()))
    np.testing.assert_allclose(_np(hs), _np(jhs), **TOL)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)


def test_rglru_final_state_right_where_pallas_pads():
    """At T=20 the Pallas wrapper's unmasked padding decays h_T after the
    last step; the port's h_T is the reference oracle's."""
    a = _rglru_inputs(3, 1, 20, 6)
    jx = [jnp.asarray(a[k]) for k in "x a i lam".split()]
    _, want = jref.rglru_ref(*jx)
    _, pallas_h = rglru_pallas(*jx, interpret=True)
    _, h = ops.rglru(*(_t(a[k]) for k in "x a i lam".split()))
    np.testing.assert_allclose(_np(h), _np(want), **TOL)
    assert np.abs(_np(pallas_h) - _np(want)).max() > 1e-2


def test_rglru_step_vs_reference():
    a = _rglru_inputs(4, 2, 1, 5)
    args = [a["x"][:, 0], a["a"][:, 0], a["i"][:, 0], a["lam"], a["h0"]]
    jo, jh = jops.rglru_step(*(jnp.asarray(v) for v in args))
    o, h = ops.rglru_step(*(_t(v) for v in args))
    np.testing.assert_allclose(_np(o), _np(jo), **TOL)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)


def test_rglru_step_matches_scan():
    a = _rglru_inputs(5, 2, 5, 4)
    x, ag, ig, lam = (_t(a[k]) for k in "x a i lam".split())
    hs_ref, _ = ops.rglru(x, ag, ig, lam)
    h = torch.zeros(2, 4)
    for t in range(x.shape[1]):
        _, h = ops.rglru_step(x[:, t], ag[:, t], ig[:, t], lam, h)
        np.testing.assert_allclose(_np(h), _np(hs_ref[:, t]), **TOL)


def test_rglru_h0_seeding():
    """Chunked decode continuation: h0-seeded scan == suffix of full scan."""
    a = _rglru_inputs(6, 1, 12, 4)
    x, ag, ig, lam = (_t(a[k]) for k in "x a i lam".split())
    full, _ = ops.rglru(x, ag, ig, lam)
    head, h_mid = ops.rglru(x[:, :7], ag[:, :7], ig[:, :7], lam)
    tail, _ = ops.rglru(x[:, 7:], ag[:, 7:], ig[:, 7:], lam, h0=h_mid)
    np.testing.assert_allclose(_np(torch.cat([head, tail], 1)), _np(full), **TOL)


# --------------------------------------------------------------------------
# no hidden fallback
# --------------------------------------------------------------------------
def test_ssm_scan_cuda_rejects_cpu_tensors():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="not a CUDA device"):
        ssm_scan_cuda(x, x, torch.zeros(8, 2), torch.zeros(1, 4, 2),
                      torch.zeros(1, 4, 2), torch.zeros(8))


def test_rglru_scan_cuda_rejects_cpu_tensors():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="not a CUDA device"):
        rglru_scan_cuda(x, x, x, torch.zeros(8))


def test_scan_wrappers_reach_the_device_check_under_grad():
    """Under grad the CUDA scans take their autograd path (forward kernel
    with the chunk carries, backward kernel), which checks the device like
    the no-grad path: a CPU tensor raises there, never a refusal to
    differentiate."""
    x = torch.zeros(1, 4, 8, requires_grad=True)
    with pytest.raises(ValueError, match="not a CUDA device"):
        ssm_scan_cuda(x, x.detach(), torch.zeros(8, 2), torch.zeros(1, 4, 2),
                      torch.zeros(1, 4, 2), torch.zeros(8))
    with pytest.raises(ValueError, match="not a CUDA device"):
        rglru_scan_cuda(x.detach(), x.detach(), x.detach(),
                        torch.zeros(8, requires_grad=True))


# --------------------------------------------------------------------------
# gradients of the plain scans (CPU training of the recurrent archs)
# --------------------------------------------------------------------------
def test_ssm_scan_grads_vs_reference_chunked():
    a = _ssm_inputs(20, 2, 13, 6, 3)
    keys = "x dt A B C D h0".split()
    wy = _rng(21).standard_normal((2, 13, 6), dtype=np.float32)
    wh = _rng(22).standard_normal((2, 6, 3), dtype=np.float32)

    def jloss(*args):
        y, h = jops.ssm_scan(*args, time_chunk=4)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*(jnp.asarray(a[k]) for k in keys))
    ts = [_t(a[k]).requires_grad_() for k in keys]
    y, h = ops.ssm_scan(*ts)
    got = torch.autograd.grad((y * _t(wy)).sum() + (h * _t(wh)).sum(), ts)
    for k, g, w in zip(keys, got, want):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=k, **TOL)


def test_rglru_grads_vs_reference_chunked():
    a = _rglru_inputs(23, 2, 13, 6)
    keys = "x a i lam h0".split()
    wy = _rng(24).standard_normal((2, 13, 6), dtype=np.float32)

    def jloss(x, ag, ig, lam, h0):
        hs, hT = jops.rglru(x, ag, ig, lam, h0, time_chunk=4)
        return jnp.sum(hs * wy) + jnp.sum(hT)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(a[k]) for k in keys))
    ts = [_t(a[k]).requires_grad_() for k in keys]
    hs, hT = ops.rglru(*ts)
    got = torch.autograd.grad((hs * _t(wy)).sum() + hT.sum(), ts)
    for k, g, w in zip(keys, got, want):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=k, **TOL)

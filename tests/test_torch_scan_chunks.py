"""The chunked scan kernels' order of operations, emulated on the CPU.

``csrc/ssm_scan.cu`` and ``csrc/rglru_scan.cu`` scan time in parallel
inside a block: a chunk of ``CHUNK`` steps is cut into ``LANES`` segments
of ``SEGMENT`` consecutive steps; each lane composes its segment into one
(prod a, h) pair, a Hillis-Steele shuffle scan combines the pairs across
the lanes, (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2), with the channel's
carry from the previous chunk folded into the first lane; each lane then
re-walks its segment from the previous lane's state, and the last lane's
state carries to the next chunk.  Steps past T in the last chunk are
identity (a = 1, b = 0), and channels past I (L) in the last block are
computed and dropped.  The emulations below do that arithmetic in plain f32
torch, with the tile sizes read from the wrappers, and are held against the
JAX reference (``repro.kernels.ref``) and the port's plain versions at the
reference tolerance, 1e-4 on f32 outputs and final states.  One test reads
each ``.cu`` file and checks that its constants are the wrapper's.
"""

import math
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
LOG2E = 1.4426950408889634


def _lane_scan(P, h, carry, lanes):
    """Inclusive scan of (P, h) over dim 1 (the lanes) as the shuffles do
    it, the carry folded into lane 0; returns (each lane's starting state,
    the next carry)."""
    h = h.clone()
    h[:, 0] = P[:, 0] * carry + h[:, 0]
    off = 1
    while off < lanes:
        hp, Pp = h[:, :-off].clone(), P[:, :-off].clone()
        h[:, off:] = P[:, off:] * hp + h[:, off:]
        P = P.clone()
        P[:, off:] = P[:, off:] * Pp
        off *= 2
    start = torch.cat([carry[:, None], h[:, :-1]], dim=1)
    return start, h[:, -1]


def _chunks(T, chunk, lanes, seg):
    """(t0, valid mask (lanes, seg)) for each chunk of T steps."""
    for t0 in range(0, T, chunk):
        t = t0 + torch.arange(chunk).reshape(lanes, seg)
        yield t0, t < T


def _pad_channels(a, width, dim):
    """``a`` with dim padded by zeros to a multiple of ``width`` (the
    kernel's channel blocks)."""
    extra = -a.shape[dim] % width
    if extra == 0:
        return a
    shape = list(a.shape)
    shape[dim] = extra
    return torch.cat([a, torch.zeros(shape, dtype=a.dtype)], dim=dim)


def ssm_chunked(x, dt, A, B, C, D, h0=None, identity_pad=True):
    """The selective-scan kernel's arithmetic, in f32."""
    Bt, T, I = x.shape
    N = A.shape[1]
    lanes, seg, chunk = ss.LANES, ss.SEGMENT, ss.CHUNK
    x, dt = (_pad_channels(a.float(), ss.CHANNELS, 2) for a in (x, dt))
    A, D = _pad_channels(A.float(), ss.CHANNELS, 0), _pad_channels(D.float(), ss.CHANNELS, 0)
    Ip = x.shape[2]
    a2 = A * LOG2E                                          # (Ip, N)
    carry = torch.zeros((Bt, Ip, N)) if h0 is None else _pad_channels(h0.float(), ss.CHANNELS, 1)
    y = torch.empty((Bt, T, Ip))
    for t0, valid in _chunks(T, chunk, lanes, seg):
        idx = torch.clamp(t0 + torch.arange(chunk), max=T - 1).reshape(lanes, seg)
        dtv = dt[:, idx]                                    # (Bt, lanes, seg, Ip)
        xv = x[:, idx]
        dtx = dtv * xv
        Bv, Cv = B.float()[:, idx], C.float()[:, idx]       # (Bt, lanes, seg, N)
        v = valid[None, :, :, None] if identity_pad else torch.ones_like(valid)[None, :, :, None]
        yv = torch.zeros_like(dtv)
        for n in range(N):
            dA = torch.where(v, torch.exp2(dtv * a2[:, n]), torch.ones(()))
            u = torch.where(v, dtx * Bv[..., n, None], torch.zeros(()))
            P, h = torch.ones_like(dA[:, :, 0]), torch.zeros_like(dA[:, :, 0])
            for s in range(seg):
                h = dA[:, :, s] * h + u[:, :, s]
                P = P * dA[:, :, s]
            h, carry[..., n] = _lane_scan(P, h, carry[..., n], lanes)
            for s in range(seg):
                h = dA[:, :, s] * h + u[:, :, s]
                yv[:, :, s] = yv[:, :, s] + h * Cv[:, :, s, n, None]
        out = (yv + D * xv).reshape(Bt, chunk, Ip)
        y[:, t0:t0 + chunk] = out[:, :min(chunk, T - t0)]
    return y[..., :I], carry[:, :I]


def rglru_chunked(x, a_gate, i_gate, log_lam, h0=None, c=8.0, identity_pad=True):
    """The RG-LRU kernel's arithmetic, in f32: gates as the kernel forms
    them (sigmoid through exp2 and a reciprocal, log2 of a), then the
    chunked scan."""
    B, T, L = x.shape
    lanes, seg, chunk = rs.LANES, rs.SEGMENT, rs.CHUNK
    x, a_gate, i_gate = (_pad_channels(t.float(), rs.CHANNELS, 2)
                         for t in (x, a_gate, i_gate))
    log_lam = _pad_channels(log_lam.float(), rs.CHANNELS, 0)
    Lp = x.shape[2]
    neg_c_lam = -c * torch.where(log_lam > 20, log_lam, torch.log1p(torch.exp(log_lam)))
    carry = torch.zeros((B, Lp)) if h0 is None else _pad_channels(h0.float(), rs.CHANNELS, 1)
    hs = torch.empty((B, T, Lp))

    def sigmoid(v):
        return 1.0 / (1.0 + torch.exp2(-v * LOG2E))

    for t0, valid in _chunks(T, chunk, lanes, seg):
        idx = torch.clamp(t0 + torch.arange(chunk), max=T - 1).reshape(lanes, seg)
        xv, av, iv = x[:, idx], a_gate[:, idx], i_gate[:, idx]   # (B, lanes, seg, Lp)
        if not identity_pad:                 # zero inputs past T, as Pallas pads
            keep = valid[None, :, :, None]
            xv, av, iv = (torch.where(keep, t, torch.zeros(())) for t in (xv, av, iv))
        log_a2 = neg_c_lam * sigmoid(av) * LOG2E
        mult = torch.sqrt(torch.clamp(1.0 - torch.exp2(2.0 * log_a2), min=1e-12))
        v = valid[None, :, :, None] if identity_pad else torch.ones_like(valid)[None, :, :, None]
        a = torch.where(v, torch.exp2(log_a2), torch.ones(()))
        u = torch.where(v, mult * (sigmoid(iv) * xv), torch.zeros(()))
        P, h = torch.ones_like(a[:, :, 0]), torch.zeros_like(a[:, :, 0])
        for s in range(seg):
            h = a[:, :, s] * h + u[:, :, s]
            P = P * a[:, :, s]
        h, carry = _lane_scan(P, h, carry, lanes)
        out = torch.empty_like(a)
        for s in range(seg):
            h = a[:, :, s] * h + u[:, :, s]
            out[:, :, s] = h
        hs[:, t0:t0 + chunk] = out.reshape(B, chunk, Lp)[:, :min(chunk, T - t0)]
    return hs[..., :L], carry[:, :L]


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _ssm_arrays(seed, Bt, T, I, N):
    r = np.random.default_rng(seed)
    n = lambda *s: r.standard_normal(s, dtype=np.float32)   # noqa: E731
    return dict(x=n(Bt, T, I), dt=np.log1p(np.exp(n(Bt, T, I))),
                A=-np.exp(n(I, N)), B=n(Bt, T, N), C=n(Bt, T, N), D=n(I),
                h0=n(Bt, I, N))


def _ssm_t_cases():
    return [1, ss.SEGMENT - 1, ss.CHUNK, ss.CHUNK + 3, 2 * ss.CHUNK + 17]


def _rglru_t_cases():
    return [1, rs.SEGMENT - 1, rs.CHUNK, rs.CHUNK + 3, 2 * rs.CHUNK + 17]


@pytest.mark.parametrize("T", _ssm_t_cases())
@pytest.mark.parametrize("N", [1, 5, 16])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
def test_ssm_chunked_matches_references(T, N, with_h0):
    """The selective scan's chunked order against the JAX reference and the
    port's plain version: T around the segment and the chunk, I = CHANNELS +
    7 (a ragged channel block), N from 1 to 16."""
    Bt, I = 2, ss.CHANNELS + 7
    a = _ssm_arrays(30 + T + N, Bt, T, I, N)
    h0 = a["h0"] if with_h0 else None
    args = [torch.from_numpy(a[k]) for k in ("x", "dt", "A", "B", "C", "D")]
    th0 = torch.from_numpy(h0) if with_h0 else None
    y, hT = ssm_chunked(*args, th0)
    jy, jh = jref.ssm_scan_ref(*(jnp.asarray(a[k]) for k in ("x", "dt", "A", "B", "C", "D")),
                               None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh), **TOL)
    yr, hr = ref.ssm_scan_ref(*args, th0)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), **TOL)
    np.testing.assert_allclose(hT.numpy(), hr.numpy(), **TOL)


@pytest.mark.parametrize("T", _rglru_t_cases())
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
def test_rglru_chunked_matches_references(T, with_h0):
    """The RG-LRU's chunked order and gate arithmetic against the JAX
    reference and the port's plain version: T around the segment and the
    chunk, L = CHANNELS + 7 (a ragged channel block)."""
    B, L = 2, rs.CHANNELS + 7
    x, ag, ig = (_np(60 + T + k, B, T, L) for k in range(3))
    lam, h0 = _np(70 + T, L), (_np(80 + T, B, L) if with_h0 else None)
    th0 = torch.from_numpy(h0) if with_h0 else None
    targs = [torch.from_numpy(t) for t in (x, ag, ig, lam)]
    hs, hT = rglru_chunked(*targs, th0)
    jhs, jh = jref.rglru_ref(*(jnp.asarray(t) for t in (x, ag, ig, lam)),
                             None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), **TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh), **TOL)
    hr, hTr = ref.rglru_ref(*targs, th0)
    np.testing.assert_allclose(hs.numpy(), hr.numpy(), **TOL)
    np.testing.assert_allclose(hT.numpy(), hTr.numpy(), **TOL)


def test_zero_padded_steps_would_break_rglru_final_state():
    """The masking matters: with the last chunk's steps past T fed as zero
    inputs (what ``rglru_pallas`` does), sigmoid(0) still decays h and h_T
    misses the reference, while the identity-masked order meets it."""
    B, T, L = 1, rs.CHUNK + 3, 8
    x, ag, ig = (torch.from_numpy(_np(90 + k, B, T, L)) for k in range(3))
    lam = torch.from_numpy(_np(93, L))
    _, want = ref.rglru_ref(x, ag, ig, lam)
    _, good = rglru_chunked(x, ag, ig, lam)
    _, bad = rglru_chunked(x, ag, ig, lam, identity_pad=False)
    np.testing.assert_allclose(good.numpy(), want.numpy(), **TOL)
    assert (bad - want).abs().max().item() > 1e-2


def test_zero_padded_steps_are_identity_for_the_selective_scan_only_by_masking():
    """Steps past T are masked as identity (dA = 1, dt*B*x = 0): the
    emulation with the mask gives the reference's h_T at T = CHUNK + 3, and
    without it (the last step's inputs repeated past T) it does not."""
    Bt, T, I, N = 1, ss.CHUNK + 3, 4, 4
    a = _ssm_arrays(95, Bt, T, I, N)
    args = [torch.from_numpy(a[k]) for k in ("x", "dt", "A", "B", "C", "D")]
    _, want = ref.ssm_scan_ref(*args)
    _, good = ssm_chunked(*args)
    _, bad = ssm_chunked(*args, identity_pad=False)
    np.testing.assert_allclose(good.numpy(), want.numpy(), **TOL)
    assert (bad - want).abs().max().item() > 1e-2


@pytest.mark.parametrize("module", [ss, rs], ids=["ssm_scan", "rglru_scan"])
def test_cuda_tile_constants_match_the_wrapper(module):
    """Each ``.cu`` file states its tile constants once; the wrapper mirrors
    them, and the emulations above read the wrapper's."""
    src = (_build.CSRC / module.SOURCE).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    seg, lanes, warps, stages = (const(k) for k in ("SEG", "LANES", "WARPS", "STAGES"))
    assert module.SEGMENT == seg
    assert module.LANES == lanes
    assert module.STAGES == stages
    assert module.CHUNK == lanes * seg
    assert module.CHANNELS == warps * (32 // lanes)
    assert 32 % lanes == 0 and math.log2(lanes).is_integer()
    assert "constexpr int TC = LANES * SEG;" in src
    assert "constexpr int CH = WARPS * CPW;" in src

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

import functools
import math
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
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


def ssm_chunked(x, dt, A, B, C, D, h0=None, identity_pad=True, carries=None):
    """The selective-scan kernel's arithmetic, in f32.  With a list
    ``carries``, appends the state entering each chunk (Bt, I, N), as the
    kernel writes it for the backward."""
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
        if carries is not None:
            carries.append(carry[:, :I].clone())
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


def rglru_chunked(x, a_gate, i_gate, log_lam, h0=None, c=8.0, identity_pad=True,
                  carries=None):
    """The RG-LRU kernel's arithmetic, in f32: gates as the kernel forms
    them (sigmoid through exp2 and a reciprocal, log2 of a), then the
    chunked scan.  With a list ``carries``, appends the state entering each
    chunk (B, L)."""
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
        if carries is not None:
            carries.append(carry[:, :L].clone())
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


# --------------------------------------------------------------------------
# the backward kernels (csrc/ssm_scan_bwd.cu, csrc/rglru_scan_bwd.cu)
# --------------------------------------------------------------------------
LN2 = 0.6931471805599453


def _lane_scan_rev(P, Q, carry, lanes):
    """Reverse inclusive scan of (P, Q) over dim 1 (the lanes) as the
    kernels' shuffle-downs do it, the later chunk's carry folded into the
    last lane; returns (the q each lane starts its backward walk from, the
    earlier chunk's carry)."""
    Q = Q.clone()
    Q[:, -1] = P[:, -1] * carry + Q[:, -1]
    off = 1
    while off < lanes:
        Qn, Pn = Q[:, off:].clone(), P[:, off:].clone()
        Q[:, :-off] = P[:, :-off] * Qn + Q[:, :-off]
        P = P.clone()
        P[:, :-off] = P[:, :-off] * Pn
        off *= 2
    return torch.cat([Q[:, 1:], carry[:, None]], dim=1), Q[:, 0]


def _sum_slices():
    """``SLICES`` of ``csrc/scan_sums.cuh``: the ranges the second pass cuts
    the partials into."""
    src = (_build.CSRC / "scan_sums.cuh").read_text()
    return int(re.search(r"constexpr int SLICES = (\d+);", src).group(1))


def _sum_lead(parts):
    """The partials summed over dim 0 as the second pass adds them: cut into
    SLICES contiguous ranges of ceil(K / SLICES), each summed in order, the
    ranges' sums added in order (for K <= SLICES, k = 0, 1, ... in order)."""
    slices = _sum_slices()
    K = parts.shape[0]
    per = -(-K // slices)
    total = torch.zeros_like(parts[0])
    for sl in range(slices):
        k0 = min(K, sl * per)
        acc = torch.zeros_like(parts[0])
        for k in range(k0, min(K, k0 + per)):
            acc = acc + parts[k]
        total = total + acc
    return total


def _pairwise(a, dim):
    """a summed over ``dim`` (a power of two long) by a butterfly of
    shuffles: neighbours first, ((a0 + a1) + (a2 + a3)) + ..."""
    while a.shape[dim] > 1:
        a = a.unflatten(dim, (-1, 2))
        a = a.select(dim + 1, 0) + a.select(dim + 1, 1)
    return a.squeeze(dim)


def _block_sums(a, width, cpw):
    """(Bt, T, Ip, N) -> the per-block sums over channels, (nblk, Bt, T, N),
    as the selective-scan backward forms them: each warp's cpw channels
    added pairwise by its reduce-scatter, then the block's warps added in
    warp order."""
    Bt, T, Ip, N = a.shape
    warps = _pairwise(a.reshape(Bt, T, Ip // width, width // cpw, cpw, N), 4)
    out = torch.zeros_like(warps[:, :, :, 0])
    for k in range(warps.shape[3]):
        out = out + warps[:, :, :, k]
    return out.permute(2, 0, 1, 3)


def ssm_chunked_bwd(dy, dhT, x, dt, A, B, C, D, carries):
    """The selective-scan backward kernel's order, in f32, with its own
    tiles (``BWD_SEGMENT``, ``BWD_LANES``, ``BWD_CHANNELS``, states in
    pairs): chunks from last to first; dt, dt*x and dy zero past T; per
    state, the segment composed forwards into (prod a, h) and Q = sum_t
    (a_1...a_t) C_t dy_t, the forward lane scan from the chunk's saved
    carry and the reverse one from the later chunk's q, the re-walk and the
    backward walk, whose sums over the states of g*B and g*a*h*A*log2(e)
    give dx = dt*gb + D*dy and ddt = x*gb + gaha*ln(2); dB, dC as per-block partials (warp
    channels pairwise, warps in order) summed by the second pass; dA summed
    per segment over time, the segments in order, then over the batch; dD
    per segment over time, the segments pairwise, then over the batch.
    Returns (dx, ddt, dA, dB, dC, dD, dh0)."""
    Bt, T, I = x.shape
    N = A.shape[1]
    lanes, seg, W, G = ss.BWD_LANES, ss.BWD_SEGMENT, ss.BWD_CHANNELS, ss.BWD_GROUP
    chunk = ss.CHUNK
    pad = lambda a, d: _pad_channels(a.float(), W, d)   # noqa: E731
    x, dt, dy = pad(x, 2), pad(dt, 2), pad(dy, 2)
    Np = -(-N // G) * G                    # an odd N's last pair: a zero state
    pad_n = lambda a: _pad_channels(a.float(), Np, a.dim() - 1)   # noqa: E731
    A, D = pad_n(pad(A, 0)), pad(D, 0)
    Ip = x.shape[2]
    a2 = A * LOG2E
    Bf, Cf = pad_n(B), pad_n(C)
    qc = torch.zeros((Bt, Ip, Np)) if dhT is None else pad_n(pad(dhT, 1))
    dAs = torch.zeros((Bt, lanes, Ip, Np))
    dDs = torch.zeros((Bt, lanes, Ip))
    dx, ddt = torch.empty((Bt, T, Ip)), torch.empty((Bt, T, Ip))
    dBs, dCs = torch.zeros((Bt, T, Ip, Np)), torch.zeros((Bt, T, Ip, Np))
    for k, (t0, valid) in reversed(list(enumerate(_chunks(T, chunk, lanes, seg)))):
        idx = torch.clamp(t0 + torch.arange(chunk), max=T - 1).reshape(lanes, seg)
        v = valid[None, :, :, None]
        zero = torch.zeros(())
        dtv = torch.where(v, dt[:, idx], zero)            # (Bt, lanes, seg, Ip)
        dtx = torch.where(v, dt[:, idx] * x[:, idx], zero)
        dyv = torch.where(v, dy[:, idx], zero)
        Bv, Cv = Bf[:, idx], Cf[:, idx]                   # (Bt, lanes, seg, Np)
        cin = pad_n(pad(carries[k], 1))
        gb, gaha = torch.zeros_like(dtv), torch.zeros_like(dtv)
        dBc, dCc = torch.zeros(dtv.shape + (Np,)), torch.zeros(dtv.shape + (Np,))
        for n in range(Np):
            dA = torch.exp2(dtv * a2[:, n])
            u = dtx * Bv[..., n, None]
            P = torch.ones_like(dA[:, :, 0])
            hc, Q = torch.zeros_like(P), torch.zeros_like(P)
            for s in range(seg):
                hc = dA[:, :, s] * hc + u[:, :, s]
                P = P * dA[:, :, s]
                Q = P * (Cv[:, :, s, n, None] * dyv[:, :, s]) + Q
            start, _ = _lane_scan(P, hc, cin[..., n], lanes)
            q, qc[..., n] = _lane_scan_rev(P, Q, qc[..., n], lanes)
            h, hc = torch.empty_like(dA), start
            for s in range(seg):
                hc = dA[:, :, s] * hc + u[:, :, s]
                h[:, :, s] = hc
            dAn = torch.zeros_like(P)
            for s in reversed(range(seg)):
                g = Cv[:, :, s, n, None] * dyv[:, :, s] + q
                hprev = h[:, :, s - 1] if s > 0 else start
                gah = g * (dA[:, :, s] * hprev)
                gaha[:, :, s] = gah * a2[:, n] + gaha[:, :, s]
                gb[:, :, s] = g * Bv[:, :, s, n, None] + gb[:, :, s]
                dAn = gah * dtv[:, :, s] + dAn
                q = dA[:, :, s] * g
                dBc[:, :, s, :, n] = g * dtx[:, :, s]
                dCc[:, :, s, :, n] = dyv[:, :, s] * h[:, :, s]
            dAs[..., n] += dAn
        nt = min(chunk, T - t0)
        flat = lambda a: a.reshape((Bt, chunk) + a.shape[3:])[:, :nt]   # noqa: E731
        dx[:, t0:t0 + nt] = flat(dtv * gb + D * dyv)
        ddt[:, t0:t0 + nt] = flat(x[:, idx] * gb + gaha * LN2)
        dBs[:, t0:t0 + nt], dCs[:, t0:t0 + nt] = flat(dBc), flat(dCc)
        for s in range(seg):
            dDs = dyv[:, :, s] * torch.where(v[:, :, s], x[:, idx][:, :, s], zero) + dDs
    dB, dC = (_sum_lead(_block_sums(a, W, 32 // lanes))[..., :N] for a in (dBs, dCs))
    dA = torch.zeros_like(dAs[:, 0])
    for g in range(lanes):
        dA = dA + dAs[:, g]
    return (dx[..., :I], ddt[..., :I], _sum_lead(dA)[:I, :N], dB, dC,
            _sum_lead(_pairwise(dDs, 1))[:I], qc[:, :I, :N])


def rglru_chunked_bwd(dh, dhT, x, a_gate, i_gate, log_lam, carries, c=8.0):
    """The RG-LRU backward kernel's order, in f32, with its own tiles
    (``BWD_SEGMENT``, ``BWD_LANES``, ``BWD_CHANNELS``): chunks from last to
    first; x and dh zero and a = 1 past T; the gates formed the kernel's
    way, the segment composed forwards into (prod a, h) and Q = sum_t
    (a_1...a_t) dh_t, the forward lane scan from the chunk's saved carry and
    the reverse one from the later chunk's q, the re-walk and the backward
    walk; dlog_lam summed per segment over time (backwards), the segments
    pairwise, then over the batch.  Returns (dx, da_gate, di_gate,
    dlog_lam, dh0)."""
    B, T, L = x.shape
    lanes, seg, W, chunk = rs.BWD_LANES, rs.BWD_SEGMENT, rs.BWD_CHANNELS, rs.CHUNK
    pad = lambda a, d: _pad_channels(a.float(), W, d)   # noqa: E731
    x, a_gate, i_gate, dh = (pad(t, 2) for t in (x, a_gate, i_gate, dh))
    log_lam = pad(log_lam, 0)
    neg_c_lam = -c * torch.where(log_lam > 20, log_lam, torch.log1p(torch.exp(log_lam)))
    qc = torch.zeros((B, x.shape[2])) if dhT is None else pad(dhT, 1)
    lam = torch.zeros((B, lanes, x.shape[2]))
    grads = [torch.empty_like(x) for _ in range(3)]

    def sigmoid(v):
        return 1.0 / (1.0 + torch.exp2(-v * LOG2E))

    for k, (t0, valid) in reversed(list(enumerate(_chunks(T, chunk, lanes, seg)))):
        idx = torch.clamp(t0 + torch.arange(chunk), max=T - 1).reshape(lanes, seg)
        v = valid[None, :, :, None]
        zero = torch.zeros(())
        xv, dhv = torch.where(v, x[:, idx], zero), torch.where(v, dh[:, idx], zero)
        sa, si = sigmoid(a_gate[:, idx]), sigmoid(i_gate[:, idx])
        log_a2 = neg_c_lam * sa * LOG2E
        a = torch.where(v, torch.exp2(log_a2), torch.ones(()))
        e2 = torch.exp2(2.0 * log_a2)
        m = torch.sqrt(torch.clamp(1.0 - e2, min=1e-12))
        u = m * (si * xv)
        P = torch.ones_like(a[:, :, 0])
        hc, Q = torch.zeros_like(P), torch.zeros_like(P)
        for s in range(seg):
            hc = a[:, :, s] * hc + u[:, :, s]
            P = P * a[:, :, s]
            Q = P * dhv[:, :, s] + Q
        start, _ = _lane_scan(P, hc, pad(carries[k], 1), lanes)
        q, qc = _lane_scan_rev(P, Q, qc, lanes)
        h, hc = torch.empty_like(a), start
        for s in range(seg):
            hc = a[:, :, s] * hc + u[:, :, s]
            h[:, :, s] = hc
        out = [torch.zeros_like(a) for _ in range(3)]
        for s in reversed(range(seg)):
            g = dhv[:, :, s] + q
            hprev = h[:, :, s - 1] if s > 0 else start
            sa_, e2_, m_, si_, x_ = (t[:, :, s] for t in (sa, e2, m, si, xv))
            gm = g * m_
            dm = torch.where(1.0 - e2_ > 1e-12, -e2_ * (1.0 / m_), zero)
            dla = g * (hprev * a[:, :, s] + dm * si_ * x_)
            lam = torch.where(v[:, :, s], dla * sa_, zero) + lam
            out[0][:, :, s] = gm * si_
            out[1][:, :, s] = dla * neg_c_lam * sa_ * (1.0 - sa_)
            out[2][:, :, s] = gm * x_ * si_ * (1.0 - si_)
            q = a[:, :, s] * g
        nt = min(chunk, T - t0)
        for dst, o in zip(grads, out):
            dst[:, t0:t0 + nt] = o.reshape(B, chunk, -1)[:, :nt]
    dlam = _sum_lead(_pairwise(lam, 1) * (-c) * torch.sigmoid(log_lam))
    return (grads[0][..., :L], grads[1][..., :L], grads[2][..., :L],
            dlam[:L], qc[:, :L])


@functools.cache
def _jax_ssm_grad(chunk):
    """jax.grad of sum(y * wy) + sum(h_T * wh) through the reference's
    chunked selective scan, jitted once per time chunk (h0 = 0 is the
    reference's h0=None, wh = 0 no cotangent on h_T)."""
    def loss(x, dt, A, B, C, D, h0, wy, wh):
        y, h = jops.ssm_scan(x, dt, A, B, C, D, h0, time_chunk=chunk)
        return jnp.sum(y * wy) + jnp.sum(h * wh)
    return jax.jit(jax.grad(loss, argnums=tuple(range(7))))


@functools.cache
def _jax_rglru_grad(chunk):
    """The same for the reference's chunked RG-LRU."""
    def loss(x, ag, ig, lam, h0, wy, wh):
        hs, hT = jops.rglru(x, ag, ig, lam, h0, time_chunk=chunk)
        return jnp.sum(hs * wy) + jnp.sum(hT * wh)
    return jax.jit(jax.grad(loss, argnums=tuple(range(5))))


def _bwd_t_cases():
    """T around the forward's segment and chunk, and last chunks that end
    inside the backward's second segment (2 CHUNK + BWD_SEGMENT + 1) or
    partway through the chunk (200)."""
    return [1, ss.SEGMENT - 1, ss.CHUNK, ss.CHUNK + 3, 2 * ss.CHUNK + 17,
            2 * ss.CHUNK + ss.BWD_SEGMENT + 1, 200]


@pytest.mark.parametrize("T", _bwd_t_cases())
@pytest.mark.parametrize("N", [1, 3, 5, 16])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("with_dhT", [False, True], ids=["dhT=0", "dhT"])
def test_ssm_chunked_bwd_matches_references(T, N, with_h0, with_dhT):
    """The selective-scan backward's chunked order against jax.grad of the
    reference's chunked scan (time_chunk 4 and its default) and autograd of
    the port's plain version: T around the segment and the chunk, I =
    CHANNELS + 7 (a ragged channel block), N from 1 to 16, with and without
    h0 and a cotangent on h_T."""
    Bt, I = 2, ss.CHANNELS + 7
    a = _ssm_arrays(130 + T + N, Bt, T, I, N)
    r = np.random.default_rng(140 + T + N)
    wy = r.standard_normal((Bt, T, I), dtype=np.float32)
    wh = r.standard_normal((Bt, I, N), dtype=np.float32) if with_dhT else None
    keys = ("x", "dt", "A", "B", "C", "D") + (("h0",) if with_h0 else ())
    targs = [torch.from_numpy(a[k]) for k in keys]
    carries = []
    ssm_chunked(*targs[:6], targs[6] if with_h0 else None, carries=carries)
    got = ssm_chunked_bwd(torch.from_numpy(wy),
                          None if wh is None else torch.from_numpy(wh),
                          *targs[:6], carries)
    names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")[:len(keys)]

    jargs = [jnp.asarray(a[k]) for k in ("x", "dt", "A", "B", "C", "D")]
    jargs += [jnp.asarray(a["h0"] if with_h0 else np.zeros_like(a["h0"])),
              jnp.asarray(wy), jnp.asarray(wh if with_dhT else np.zeros((Bt, I, N),
                                                                      np.float32))]
    for chunk in (4, 16):
        want = _jax_ssm_grad(chunk)(*jargs)
        for name, g, w in zip(names, got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"{name} time_chunk={chunk}", **TOL)
    ts = [t.clone().requires_grad_() for t in targs]
    y, h = ref.ssm_scan_ref(*ts[:6], ts[6] if with_h0 else None)
    loss = (y * torch.from_numpy(wy)).sum()
    if with_dhT:
        loss = loss + (h * torch.from_numpy(wh)).sum()
    for name, g, w in zip(names, got, torch.autograd.grad(loss, ts)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("T", _bwd_t_cases())
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("with_dhT", [False, True], ids=["dhT=0", "dhT"])
def test_rglru_chunked_bwd_matches_references(T, with_h0, with_dhT):
    """The RG-LRU backward's chunked order and gate arithmetic against
    jax.grad of the reference's chunked scan (time_chunk 4 and its default)
    and autograd of the port's plain version: T around the segment and the
    chunk, L = CHANNELS + 7 (a ragged channel block), with and without h0
    and a cotangent on h_T."""
    B, L = 2, rs.CHANNELS + 7
    x, ag, ig = (_np(160 + T + k, B, T, L) for k in range(3))
    lam, h0 = _np(170 + T, L), _np(180 + T, B, L)
    wy, wh = _np(190 + T, B, T, L), _np(200 + T, B, L)
    arrays = [x, ag, ig, lam] + ([h0] if with_h0 else [])
    targs = [torch.from_numpy(t) for t in arrays]
    carries = []
    rglru_chunked(*targs[:4], targs[4] if with_h0 else None, carries=carries)
    got = rglru_chunked_bwd(torch.from_numpy(wy),
                            torch.from_numpy(wh) if with_dhT else None,
                            *targs[:4], carries)
    names = ("dx", "da_gate", "di_gate", "dlog_lam", "dh0")[:len(arrays)]

    jargs = [jnp.asarray(t) for t in (x, ag, ig, lam)]
    jargs += [jnp.asarray(h0 if with_h0 else np.zeros_like(h0)), jnp.asarray(wy),
              jnp.asarray(wh if with_dhT else np.zeros_like(wh))]
    for chunk in (4, 256):
        want = _jax_rglru_grad(chunk)(*jargs)
        for name, g, w in zip(names, got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"{name} time_chunk={chunk}", **TOL)
    ts = [t.clone().requires_grad_() for t in targs]
    hs, hT = ref.rglru_ref(*ts[:4], ts[4] if with_h0 else None)
    loss = (hs * torch.from_numpy(wy)).sum()
    if with_dhT:
        loss = loss + (hT * torch.from_numpy(wh)).sum()
    for name, g, w in zip(names, got, torch.autograd.grad(loss, ts)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("module", [ss, rs], ids=["ssm_scan", "rglru_scan"])
def test_backward_tile_constants_match_the_wrapper(module):
    """The backward kernel walks the forward's chunks in tiles of its own:
    its ``.cu`` file states its constants, the wrapper mirrors them
    (``BWD_SEGMENT``, ``BWD_LANES``, ``BWD_CHANNELS``, ``BWD_STAGES`` and,
    for the selective scan, ``BWD_GROUP``), the emulations above read the
    wrapper's, and its chunk TC = LANES * SEG is the forward's CHUNK."""
    bwd = (_build.CSRC / module.BWD_SOURCE).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", bwd).group(1))

    seg, lanes, warps, stages = (const(k) for k in ("SEG", "LANES", "WARPS", "STAGES"))
    assert module.BWD_SEGMENT == seg
    assert module.BWD_LANES == lanes
    assert module.BWD_STAGES == stages
    assert module.BWD_CHANNELS == warps * (32 // lanes)
    assert lanes * seg == module.CHUNK
    assert 32 % lanes == 0 and math.log2(lanes).is_integer()
    assert "constexpr int TC = LANES * SEG;" in bwd
    assert "constexpr int CH = WARPS * CPW;" in bwd
    if module is ss:
        assert const("GROUP") == ss.BWD_GROUP
    assert _sum_slices() >= 1

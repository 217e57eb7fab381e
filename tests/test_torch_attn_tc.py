"""The rounding of the tensor-core flash-attention kernels, emulated on the CPU.

The bf16 tensor-core paths of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` round where the plain attention does not.
The forward rounds P to bf16 before P·V, tile by tile of its online
softmax: on the wgmma path 128-key tiles at head dims 64 and 128 and
64-key tiles at 256, 32-key tiles on the mma.sync path (head dims 16 and
32), as the wrapper's mirror of the kernels' constants says
(``WGMMA_TILES``, ``MMA_TILE_KEYS``, checked against the ``.cu`` file
below).  The backward rounds P and dS to bf16 before dV = Pᵀ·dO,
dK = dSᵀ·Q and dQ = dS·K, accumulates in f32 (on the wgmma path dK / dV
over stages of 128 queries at head dim 64 and 64 at 128 and 256, dQ over
stages of 128 keys at 64 and 128 and 64 keys at 256, as
``WGMMA_BWD_TILES`` says), sums each group of query heads'
dK / dV partials in f32 and rounds once; its Δ = rowsum(dO·O) reads O as
the forward's bf16 output plus the residual the forward lost in rounding
it.  The emulations below do that arithmetic in plain torch, on
bf16 inputs, and are held against the JAX reference in f32 (the forward
against ``repro.kernels.ref.attention_ref``, the gradients against
``jax.grad`` of the reference's chunked attention) at the bf16 tolerance,
atol and rtol 2e-2, that ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the kernels to on the card.  So the kernels' rounding is shown to fit
that tolerance before any card runs them.
"""

import math
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from test_torch_cuda import WGMMA_BWD_CASES, WGMMA_FWD_CASES  # noqa: E402

TOL = 2e-2
LOG2E = 1.4426950408889634


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _mask(T, S, causal, window):
    qpos = torch.arange(T)[:, None] + (S - T)
    kpos = torch.arange(S)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k):
    """(B,H,T,S) f32 products of bf16-valued q (B,T,H,D) and k (B,S,K,D)."""
    H, K = q.shape[2], k.shape[2]
    return torch.einsum("bthd,bshd->bhts", q, k.repeat_interleave(H // K, 2))


def tile_keys(D):
    """Keys a KV tile of the bf16 forward kernel at head dim D."""
    return fa.WGMMA_TILES[D][1] if D in fa.WGMMA_TILES else fa.MMA_TILE_KEYS


def tc_forward(q, k, v, causal, window):
    """The forward kernel's arithmetic: online softmax in the log2 domain
    over KV tiles of ``tile_keys(D)`` keys from key 0 (the kernels start at
    a multiple of the tile; tiles a row cannot see change nothing), P
    rounded to bf16 before P·V, f32 m, l and accumulator; output rounded to
    bf16.  Returns (o, lse, o_lo), o_lo the bf16 residual that training
    asks for: o + o_lo is the f32 output."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    bk = tile_keys(D)
    vf = v.repeat_interleave(H // K, 2)
    x = (_scores(q, k) * (D ** -0.5 * LOG2E)).masked_fill(
        ~_mask(T, S, causal, window), float("-inf"))
    m = torch.full((B, H, T), float("-inf"))
    l = torch.zeros((B, H, T))
    acc = torch.zeros((B, H, T, D))
    for k0 in range(0, S, bk):
        xt = x[..., k0:k0 + bk]
        m_new = torch.maximum(m, xt.amax(-1))
        seen = m_new != float("-inf")
        corr = torch.where(seen, torch.exp2(m - m_new), torch.ones(()))
        p = torch.where(seen[..., None], torch.exp2(xt - m_new[..., None]),
                        torch.zeros(()))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhts,bshd->bhtd", _bf16(p), vf[:, k0:k0 + bk])
        m = m_new
    o = torch.where(l[..., None] > 0, acc / l[..., None], torch.zeros(()))
    lse = torch.where(l > 0, (m + torch.log2(l)) / LOG2E,
                      torch.full((), float("-inf")))
    o = o.permute(0, 2, 1, 3)
    return _bf16(o), lse, _bf16(o - _bf16(o))


def bwd_stages(D, T, S):
    """(queries a dK/dV stage, keys a dQ stage) of the bf16 backward at
    head dim D: the wgmma kernels' tiles, from the wrapper's mirror; else
    one stage (the mma.sync kernels' tiles move only the f32 sum order)."""
    if D in fa.WGMMA_BWD_TILES:
        bq, _, _, _, dq_bn, _ = fa.WGMMA_BWD_TILES[D]
        return bq, dq_bn
    return T, S


def tc_backward(q, k, v, o, o_lo, lse, dout, causal, window, groups):
    """The backward kernels' arithmetic: Δ = rowsum(dO·(o + o_lo)),
    P = exp(S·scale − lse) and dS = P·(dP − Δ) in f32, rounded to bf16
    before their products; f32 accumulation stage by stage (``bwd_stages``:
    dK / dV over query stages, head by head of a group, dQ over key
    stages); each of ``groups`` groups of a KV head's query heads summed
    into an f32 partial, the partials summed in order and rounded to bf16
    once.  Returns (dq, dk, dv)."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    rep, scale = H // K, D ** -0.5
    bq, bk = bwd_stages(D, T, S)
    delta = (dout * (o + o_lo)).sum(-1).permute(0, 2, 1)        # (B,H,T)
    visible = _mask(T, S, causal, window) & torch.isfinite(lse)[..., None]
    p = torch.where(visible, torch.exp2(_scores(q, k) * (scale * LOG2E)
                                        - lse[..., None] * LOG2E),
                    torch.zeros(()))
    dp = _scores(dout, v)
    ds = p * (dp - delta[..., None])
    pb, dsb = _bf16(p), _bf16(ds)
    kf = k.repeat_interleave(rep, 2)
    dq = torch.zeros_like(q)
    for k0 in range(0, S, bk):
        dq += torch.einsum("bhts,bshd->bthd", dsb[..., k0:k0 + bk], kf[:, k0:k0 + bk])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for kh in range(K):
        for grp in range(groups):
            part_k, part_v = torch.zeros_like(k[:, :, kh]), torch.zeros_like(v[:, :, kh])
            for h in range(kh * rep + grp * rep // groups,
                           kh * rep + (grp + 1) * rep // groups):
                for q0 in range(0, T, bq):
                    rows = slice(q0, q0 + bq)
                    part_v += torch.einsum("bts,btd->bsd", pb[:, h, rows], dout[:, rows, h])
                    part_k += torch.einsum("bts,btd->bsd", dsb[:, h, rows], q[:, rows, h])
            dk[:, :, kh] += part_k
            dv[:, :, kh] += part_v
    return _bf16(dq * scale), _bf16(dk * scale), _bf16(dv)


def _inputs(seed, B, T, S, H, K, D):
    """bf16-valued f32 arrays q, k, v, dout."""
    rng = np.random.default_rng(seed)
    shapes = ((B, T, H, D), (B, S, K, D), (B, S, K, D), (B, T, H, D))
    return [_bf16(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))).numpy()
            for s in shapes]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


# B, T, S, H, K, D, causal, window: head dim 256 at recurrentgemma's GQA
# (16:1) with a window that empties tiles, rows that see no key (T > S),
# non-causal with T != S, and ragged tiles; paligemma's MQA (8:1) with no
# window; head dim 64 non-causal with T != S, whisper's MHA cross-attention.
FWD_CASES = [
    (1, 256, 256, 16, 1, 256, True, 0),
    (1, 256, 256, 16, 1, 256, True, 48),
    (1, 100, 60, 4, 2, 256, True, 0),
    (2, 70, 130, 4, 1, 256, False, 0),
    (1, 256, 256, 8, 1, 256, True, 0),
    (2, 70, 130, 12, 12, 64, False, 0),
]


def _lse_reference(q, k, causal, window):
    """Each row's log-sum-exp of its scaled, masked scores (B,H,T) in jnp;
    -inf where a row sees no key."""
    H, K, D = q.shape[2], k.shape[2], q.shape[3]
    T, S = q.shape[1], k.shape[1]
    s = jnp.einsum("bthd,bshd->bhts", jnp.asarray(q),
                   jnp.repeat(jnp.asarray(k), H // K, axis=2)) * D ** -0.5
    mask = jnp.asarray(_mask(T, S, causal, window).numpy())
    return jax.scipy.special.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)


# FWD_CASES' first case is also one of WGMMA_FWD_CASES at head dim 256.
@pytest.mark.parametrize("case", FWD_CASES + [c for c in WGMMA_FWD_CASES
                                              if c not in FWD_CASES], ids=str)
def test_tc_forward_rounding_within_bf16_tolerance_of_reference(case):
    B, T, S, H, K, D, causal, window = case
    q, k, v, _ = _inputs(20, B, T, S, H, K, D)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window)
    got, lse, _ = tc_forward(*(torch.from_numpy(a) for a in (q, k, v)), causal, window)
    _close(got, want)
    # Rows that see no key return 0 and write lse = -inf; the others' lse is
    # the reference's to f32 rounding (1e-4, as the card holds the kernels').
    blind = ~_mask(T, S, causal, window).any(-1)
    assert bool((got[:, blind] == 0).all())
    assert bool(torch.isinf(lse[..., blind]).all())
    if T > S:
        assert bool(blind.any())
    want_lse = np.asarray(_lse_reference(q, k, causal, window))
    assert bool(np.isneginf(want_lse[..., blind.numpy()]).all())
    np.testing.assert_allclose(lse[..., ~blind].numpy(), want_lse[..., ~blind.numpy()],
                               atol=1e-4, rtol=1e-4)


def test_forward_tile_constants_match_the_wrapper():
    """``flash_attention.cu`` states the forward's tiles once; the wrapper
    mirrors them, and ``tc_forward`` reads the wrapper's."""
    src = (_build.CSRC / fa.SOURCE).read_text()
    tiles = {int(d): tuple(map(int, rest)) for d, *rest in re.findall(
        r"struct Tiles<(\d+)> \{ static constexpr int BM = (\d+), BN = (\d+), "
        r"STAGES = (\d+); \};", src)}
    assert tiles == fa.WGMMA_TILES
    consumers = int(re.search(r"constexpr int CONSUMERS = (\d+);", src).group(1))
    assert all(bm == 64 * consumers for bm, _, _ in tiles.values())
    # The path query sends exactly these head dims to the wgmma kernel.
    dims = " || ".join(f"D == {d}" for d in sorted(tiles))
    assert f"if ({dims}) return 2;" in src
    mma = src[src.index("namespace tc {"):src.index("}  // namespace tc")]
    assert int(re.search(r"constexpr int BK = (\d+);", mma).group(1)) == fa.MMA_TILE_KEYS


def test_backward_tile_constants_match_the_wrapper():
    """``flash_attention_bwd.cu`` states the wgmma backward's tiles once; the
    wrapper mirrors them, ``tc_backward`` reads the wrapper's, and the path
    query sends exactly those head dims to the wgmma kernels (path 2)."""
    src = (_build.CSRC / fa.BWD_SOURCE).read_text()
    tiles = {int(d): tuple(map(int, rest)) for d, *rest in re.findall(
        r"struct Tiles<(\d+)> \{ static constexpr int BQ = (\d+), BN = (\d+), "
        r"STAGES = (\d+), DQ_BM = (\d+), DQ_BN = (\d+), DQ_STAGES = (\d+); \};", src)}
    assert tiles == fa.WGMMA_BWD_TILES
    wgb = src[src.index("namespace wgb {"):src.index("}  // namespace wgb")]
    consumers = int(re.search(r"constexpr int CONSUMERS = (\d+);", wgb).group(1))
    rows = int(re.search(r"constexpr int ROWS = (\d+);", wgb).group(1))
    for D, (bq, bn, _, dq_bm, dq_bn, _) in tiles.items():
        # A consumer warpgroup owns 64 query rows of a dQ block, and every
        # tile is whole TMA boxes.
        assert dq_bm == 64 * consumers
        assert all(x % rows == 0 for x in (bq, bn, dq_bm, dq_bn))
        # A dK/dV block: at head dims 64 and 128 each consumer owns 64 keys;
        # at 256 the consumers share 64 keys and split the output columns.
        assert bn == (64 if D == 256 else 64 * consumers)
    assert "constexpr int HALF = D / CONSUMERS;" in wgb
    path = src[src.index('extern "C" int repro_flash_attention_bwd_path'):]
    dims = " || ".join(f"D == {d}" for d in sorted(tiles))
    assert path.index(f"if ({dims}) return 2;") < path.index("}")
    assert bwd_stages(64, 300, 300) == (tiles[64][0], tiles[64][4])
    assert bwd_stages(256, 300, 300) == (tiles[256][0], tiles[256][4]) == (64, 64)


# D in {64, 128} at T = S = 256 and GQA 12:1, causal and windowed; the
# group counts are the split of the starcoder2-3b training shape (4) and
# one group per head (12).  The wgmma kernels' tile edges at D in {64, 128}
# (WGMMA_BWD_CASES, with the split the kernels take there), and granite's
# GQA 2:1 (D=64) and phi3.5's GQA 4:1 (D=128) in one group, their split at
# their training shapes.  Head dim 256 at recurrentgemma's GQA 16:1: T = S =
# 256, causal, windowed, G = 6 and 16; T > S, so some rows see no key; and a
# non-causal case with T != S.  Head dim 64, non-causal, T != S: whisper's
# MHA encoder and cross-attention (one group per KV head, T < S and T > S)
# and a GQA 2:1 case split in 2.  Head dim 256 at paligemma's MQA 8:1,
# causal with no window: G = 8 and 4.  Then the splits the wgmma kernel
# takes at head dim 256 (64-key dK/dV blocks): paligemma's MQA 8:1 with
# G = 6 and recurrentgemma's 16:1 with G = 3, neither of which divides its
# group, causal and windowed, with T > S and non-causal T != S.
BWD_CASES = ([(1, 256, 256, 12, 1, D, True, window, groups)
              for D in (64, 128) for window in (0, 48) for groups in (4, 12)]
             + [(1, 256, 256, 16, 1, 256, True, window, groups)
                for window in (0, 48) for groups in (6, 16)]
             + [(1, 100, 60, 16, 1, 256, True, 0, 6),
                (2, 70, 130, 16, 1, 256, False, 0, 6)]
             + [(2, 70, 130, 12, 12, 64, False, 0, 1),
                (1, 150, 90, 4, 4, 64, False, 0, 1),
                (1, 96, 200, 4, 2, 64, False, 0, 2)]
             + [(1, 256, 256, 8, 1, 256, True, 0, groups) for groups in (8, 4)]
             + [case + (groups,) for case, groups in WGMMA_BWD_CASES]
             + [(1, 256, 256, 16, 8, 64, True, 0, 1), (1, 256, 256, 32, 8, 128, True, 0, 1)]
             + [(1, 256, 256, 8, 1, 256, True, 0, 6), (1, 256, 256, 16, 1, 256, True, 48, 3),
                (1, 100, 60, 16, 1, 256, True, 0, 3), (2, 70, 130, 8, 1, 256, False, 0, 6)])


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_tc_backward_rounding_within_bf16_tolerance_of_reference(case):
    B, T, S, H, K, D, causal, window, groups = case
    q, k, v, dout = _inputs(21, B, T, S, H, K, D)
    # The chunked attention masks by adding -1e30, so a row that sees no
    # key (T > S) averages all of v there; the full reference, like the
    # kernels, gives it 0.  Where a row is blind, hold against that one.
    blind = bool((~_mask(T, S, causal, window).any(-1)).any())

    def jloss(q, k, v):
        if blind:
            o = jref.attention_ref(q, k, v, causal=causal, window=window)
        else:
            o = jops.flash_attention(q, k, v, causal=causal, window=window,
                                     q_chunk=64, kv_chunk=64)
        return jnp.sum(o * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    o, lse, o_lo = tc_forward(tq, tk, tv, causal, window)
    got = tc_backward(tq, tk, tv, o, o_lo, lse, tdo, causal, window, groups)
    for g, w in zip(got, want):
        assert bool(g.abs().sum() > 0)
        _close(g, w)


def test_tc_backward_group_count_changes_only_the_f32_sum_order():
    """The G partials are summed in f32 and rounded once, so the group
    count moves dK / dV by f32 rounding, far below one bf16 step."""
    B, T, S, H, K, D = 1, 64, 64, 12, 1, 64
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(22, B, T, S, H, K, D))
    o, lse, o_lo = tc_forward(q, k, v, True, 0)
    by_g = [tc_backward(q, k, v, o, o_lo, lse, dout, True, 0, g)
            for g in (1, 4, 5, 12)]
    for other in by_g[1:]:
        for a, b in zip(by_g[0][1:], other[1:]):
            # One bf16 ulp at most: a value near a rounding boundary may
            # round either way after an f32 reorder.
            ulp = torch.exp2(torch.floor(torch.log2(a.abs().clamp(min=1e-30)))) * 2 ** -7
            assert bool(((a - b).abs() <= ulp).all())
            assert math.isclose(float(a.abs().sum()), float(b.abs().sum()),
                                rel_tol=1e-3)

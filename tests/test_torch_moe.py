"""The port's mixture of experts (``repro_torch.models.moe``, the
``sort_scatter`` path) and the two MoE archs (granite-moe-1b-a400m,
phi3.5-moe-42b-a6.6b) against the JAX reference, in f32 on the CPU.

Parameters come from the reference's ``moe_init`` / ``init_params``
through ``repro_torch.convert``; inputs are seeded numpy.  The MoE layer's
output, aux loss and gradients (x, router, experts) are held at 1e-4; its
routing (slab rows, source tokens, kept-slot mask, expert counts) exactly,
in a case where the capacity drops slots too.  The whole models: forward
logits and aux, prefill and three decode steps, and one train step with 1
and with 2 microbatches, at the tolerances of ``tests/test_torch_train.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import granite_moe_1b as jgranite  # noqa: E402
from repro.configs import phi35_moe as jphi  # noqa: E402
from repro.configs.registry import tiny_config as jtiny  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch.configs import granite_moe_1b as tgranite  # noqa: E402
from repro_torch.configs import phi35_moe as tphi  # noqa: E402
from repro_torch.configs.registry import tiny_config  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference, reference_leaf,
                                 to_tensor)
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

MOE = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"]
PAIRS = {"granite-moe-1b-a400m": (jgranite, tgranite),
         "phi3.5-moe-42b-a6.6b": (jphi, tphi)}
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(arch, **kw):
    jc = dataclasses.replace(jtiny(arch), dtype=jnp.float32, **kw)
    tc = dataclasses.replace(tiny_config(arch), dtype=torch.float32, **kw)
    return jc, tc


def _layer(arch, seed=0, **kw):
    """(jc, tc, reference MoE params, port MoE params as tensors)."""
    jc, tc = _cfgs(arch, **kw)
    jp = jax.device_get(JM.moe_init(jax.random.PRNGKey(seed), jc))
    return jc, tc, jp, {k: to_tensor(v) for k, v in jp.items()}


def _x(seed, B, T, D):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("which", ["CONFIG", "TINY"])
def test_config_field_equal_to_reference(arch, which):
    jc, tc = (getattr(m, which) for m in PAIRS[arch])
    ja, ta = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert ja.keys() == ta.keys()
    for f in ja:
        if f in ("dtype", "opt_state_dtype"):
            assert str(ta[f]).removeprefix("torch.") == jnp.dtype(ja[f]).name, f
        else:
            assert ta[f] == ja[f], f
    for prop in ("vocab_padded", "head_dim", "n_super", "is_moe",
                 "params_total", "params_active"):
        v, w = getattr(jc, prop), getattr(tc, prop)
        assert (v() if callable(v) else v) == (w() if callable(w) else w), prop


@pytest.mark.parametrize("n_tokens", [1, 4, 37, 4096])
def test_capacity_matches_reference(n_tokens):
    for arch in MOE:
        for cfg in (PAIRS[arch][1].CONFIG, PAIRS[arch][1].TINY):
            jcfg = getattr(PAIRS[arch][0], "CONFIG" if cfg.n_layers > 2 else "TINY")
            assert TM.capacity(cfg, n_tokens) == JM.capacity(jcfg, n_tokens)


def test_moe_params_match_reference_init():
    """Same leaves, shapes, dtypes (router f32, experts in cfg.dtype) and
    init scale as the reference's ``moe_init``."""
    for arch in MOE:
        cfg = tiny_config(arch)
        p = TT._pdict(TM.moe_params(cfg), "cpu")
        TM.moe_init_(p, cfg, torch.Generator().manual_seed(0))
        ref = JM.moe_init(jax.random.PRNGKey(0), jtiny(arch))
        assert sorted(p) == sorted(ref)
        for k, v in ref.items():
            assert tuple(p[k].shape) == v.shape, k
            assert str(p[k].dtype).removeprefix("torch.") == jnp.dtype(v.dtype).name, k
        assert p["router"].dtype == torch.float32
        std = p["wo"].float().std().item()
        assert abs(std * cfg.d_ff ** 0.5 - 1.0) < 0.15


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity", [2.0, 0.25], ids=["no-drop", "drops"])
def test_route_matches_reference(arch, capacity):
    jc, tc, jp, tp = _layer(arch, moe_capacity=capacity)
    E, k = tc.moe_experts, tc.moe_topk
    S = 64
    xf = _x(1, 1, S, tc.d_model)[0]
    C = TM.capacity(tc, S)
    want = JM._route(jnp.asarray(xf), jnp.asarray(jp["router"]), E, k, C)
    got = TM._route(torch.from_numpy(xf), tp["router"], E, k, C)
    dest, tok, wslot, keep, counts, probs = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got.dest.numpy(), dest)
    np.testing.assert_array_equal(got.tok.numpy(), tok)
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_array_equal(got.counts.numpy(), counts)
    np.testing.assert_allclose(got.wslot.numpy(), wslot, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got.probs.numpy(), probs, atol=1e-6, rtol=1e-6)
    assert sorted(got.order.tolist()) == list(range(S * k))
    dropped = int((~got.keep).sum())
    if capacity < 1:
        assert C == 8 and dropped > 0, (C, dropped)
        assert bool((got.dest[~got.keep] == E * C).all())
        assert float(got.wslot[~got.keep].abs().sum()) == 0.0
    else:
        assert dropped == 0


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity", [2.0, 0.25], ids=["no-drop", "drops"])
def test_moe_forward_matches_reference(arch, capacity):
    jc, tc, jp, tp = _layer(arch, moe_capacity=capacity)
    x = _x(2, 2, 32, tc.d_model)
    want_y, want_aux = JM.moe_forward(jax.tree.map(jnp.asarray, jp),
                                      jnp.asarray(x), jc)
    got_y, got_aux = TM.moe_forward(tp, torch.from_numpy(x), tc)
    assert got_y.shape == x.shape and got_aux.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity", [2.0, 0.25], ids=["no-drop", "drops"])
def test_moe_gradients_match_reference(arch, capacity):
    """d/d(x, router, experts) of sum(y * cot) + 0.5 * aux."""
    jc, tc, jp, tp = _layer(arch, moe_capacity=capacity)
    x = _x(3, 2, 32, tc.d_model)
    cot = _x(4, 2, 32, tc.d_model)

    def jloss(xx, p):
        y, aux = JM.moe_forward(p, xx, jc)
        return jnp.sum(y * cot) + 0.5 * aux

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                              jax.tree.map(jnp.asarray, jp))
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y, aux = TM.moe_forward(pt, xt, tc)
    loss = (y * torch.from_numpy(cot)).sum() + 0.5 * aux
    names = sorted(pt)
    grads = torch.autograd.grad(loss, [xt] + [pt[n] for n in names])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    for n, g in zip(names, grads[1:]):
        want = np.asarray(jgp[n])
        assert np.abs(want).max() > 0, n
        np.testing.assert_allclose(g.numpy(), want, err_msg=n, **TOL)


def test_moe_is_the_same_bits_on_a_second_call():
    """The combine sums in a fixed order, forward and backward."""
    jc, tc, jp, tp = _layer("granite-moe-1b-a400m", moe_capacity=0.25)
    x = torch.from_numpy(_x(5, 2, 32, tc.d_model))
    outs = []
    for _ in range(2):
        xt = x.clone().requires_grad_()
        y, aux = TM.moe_forward(tp, xt, tc)
        (gx,) = torch.autograd.grad(y.square().sum() + aux, [xt])
        outs.append((y, aux, gx))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_moe_accumulates_into_no_shared_row():
    """Forward and backward, no op adds into a row that another write
    shares (a scatter-add, an accumulating index_put, an index_add): those
    sum in the order their atomics land on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            accumulate = kwargs.get("accumulate", len(args) > 3 and args[3] is True)
            self.seen.append((str(func), accumulate))
            return func(*args, **kwargs)

    jc, tc, jp, tp = _layer("granite-moe-1b-a400m", moe_capacity=0.25)
    xt = torch.from_numpy(_x(6, 2, 32, tc.d_model)).requires_grad_()
    pt = {k: v.clone().requires_grad_() for k, v in tp.items()}
    with Ops() as mode:
        y, aux = TM.moe_forward(pt, xt, tc)
        torch.autograd.grad(y.square().sum() + aux, [xt, *pt.values()])
    names = [f for f, _ in mode.seen]
    assert any("index_put" in f for f in names)
    bad = [f for f, acc in mode.seen
           if acc or "index_add" in f or "scatter_add" in f
           or "index_put" in f and "accumulate" in f]
    assert not bad, bad


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------
@pytest.fixture(scope="module", params=MOE)
def models(request):
    arch = request.param
    jc, tc = _cfgs(arch)
    params = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jc))
    model = TT.Transformer(tc, device="cpu")
    model.load_state_dict(params_from_reference(params, tc))
    return arch, jc, tc, jax.tree.map(jnp.asarray, params), model


def _tokens(seed, B, T, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)


def test_params_from_reference_covers_the_experts(models):
    arch, jc, tc, params, model = models
    sd = model.state_dict()
    E, D, F = tc.moe_experts, tc.d_model, tc.d_ff
    for i in range(tc.n_layers):
        assert sd[f"layers.{i}.ffn.router"].shape == (D, E)
        assert sd[f"layers.{i}.ffn.router"].dtype == torch.float32
        assert sd[f"layers.{i}.ffn.wi"].shape == (E, D, F)
        assert sd[f"layers.{i}.ffn.wo"].shape == (E, F, D)
        for leaf in ("router", "wi", "wg", "wo"):
            n = f"layers.{i}.ffn.{leaf}"
            np.testing.assert_array_equal(
                sd[n].numpy(), reference_leaf(jax.device_get(params), n, tc))


def test_forward_logits_and_aux_match_reference(models):
    arch, jc, tc, params, model = models
    toks = _tokens(2, 2, 12, jc.vocab)
    want, want_aux = JT.forward(params, jnp.asarray(toks), jc)
    with torch.inference_mode():
        got, aux = model(torch.from_numpy(toks).long())
    V = jc.vocab
    np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(want)[..., :V],
                               **TOL)
    assert float(want_aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_prefill_and_decode_match_reference(models):
    arch, jc, tc, params, model = models
    B, S, EXTRA = 2, 8, 3
    toks = _tokens(3, B, S + EXTRA, jc.vocab)
    want, jcache = JT.prefill(params, jnp.asarray(toks[:, :S]), jc,
                              max_len=S + EXTRA)
    with torch.inference_mode():
        got, tcache = model.prefill(torch.from_numpy(toks[:, :S]).long(),
                                    S + EXTRA)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for i in range(EXTRA):
            cur = toks[:, S + i:S + i + 1]
            want, jcache = JT.decode_step(params, jcache, jnp.asarray(cur),
                                          jnp.int32(S + i), jc)
            got, tcache = model.decode_step(tcache, torch.from_numpy(cur).long(),
                                            S + i)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"step {i}", atol=5e-4, rtol=5e-4)


def _np_batch(seed, vocab, B=4, S=16):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", MOE)
def test_train_step_matches_reference(arch, M):
    """One step from the same state and batch: loss, CE, aux (0 with
    microbatches, as in the reference), grad norm, updated parameters and
    both moments (``weight_decay=0``, see ``tests/test_torch_train.py``)."""
    jc, tc = _cfgs(arch)
    jopt = JO.AdamWConfig(state_dtype=jc.opt_state_dtype, weight_decay=0.0)
    topt = TO.AdamWConfig(state_dtype=tc.opt_state_dtype, weight_decay=0.0)
    jstate = JTS.train_state_init(jax.random.PRNGKey(0), jc, jopt)
    host = jax.device_get(jstate)
    model = TT.Transformer(tc, device="cpu")
    model.load_state_dict(params_from_reference(host["params"], tc))
    tstate = {"params": model.requires_grad_(True),
              "opt": opt_state_from_reference(host["opt"], tc),
              "step": to_tensor(np.asarray(host["step"]))}
    batch = _np_batch(5, jc.vocab)
    jnew, jm = jax.jit(JTS.make_train_step(jc, jopt, num_microbatches=M))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = make_train_step(tc, topt, num_microbatches=M)(
        tstate, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    jnew = jax.device_get(jnew)
    for key in ("loss", "ce", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    assert (float(tm["moe_aux"]) > 0) == (M == 1)
    for n, p in tnew["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   reference_leaf(jnew["params"], n, tc),
                                   err_msg=n, atol=2e-4, rtol=2e-4)
        for mom in ("m", "v"):
            np.testing.assert_allclose(tnew["opt"][mom][n].numpy(),
                                       reference_leaf(jnew["opt"][mom], n, tc),
                                       err_msg=f"{mom} {n}", atol=2e-4, rtol=2e-4)


def test_remat_gives_the_same_gradients_and_aux():
    """A checkpointed super-block returns its aux with its output; the
    gradients match the run without checkpoints."""
    base = dataclasses.replace(tiny_config("phi3.5-moe-42b-a6.6b"),
                               dtype=torch.float32, n_layers=3)
    toks = torch.from_numpy(_tokens(7, 2, 12, base.vocab)).long()
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        model.requires_grad_(True)
        logits, aux = model(toks)
        loss = logits[..., :cfg.vocab].logsumexp(-1).mean() + aux
        out[remat] = (aux.detach(), torch.autograd.grad(loss, list(model.parameters())))
    assert torch.equal(out[True][0], out[False][0])
    for g, r in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(g, r, atol=1e-6, rtol=1e-5)

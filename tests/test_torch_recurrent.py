"""Port recurrent families (falcon-mamba, recurrentgemma) against the JAX
reference, in f32 on the CPU.

Mixers are held at the ``tests/test_torch_layers.py`` tolerance (1e-5), with
parameters from the reference's own ``*_init`` (moved off their constant
starting values so that they count) and seeded numpy activations.  Whole
TINY models load the reference's parameters through ``params_from_reference``
and are held at the ``tests/test_serve.py`` tolerances: 2e-4 for forward and
prefill logits, 5e-4 for teacher-forced decode, 1e-3 for the ring-cache long
decode; greedy tokens must be identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import falcon_mamba_7b as jmamba  # noqa: E402
from repro.configs import recurrentgemma_9b as jrg  # noqa: E402
from repro.configs import starcoder2_3b as jsc  # noqa: E402
from repro.configs.registry import tiny_config as jtiny  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.decode import generate as jgenerate  # noqa: E402
from repro_torch.configs import falcon_mamba_7b as tmamba  # noqa: E402
from repro_torch.configs import qwen3_32b as tqwen  # noqa: E402
from repro_torch.configs import recurrentgemma_9b as trg  # noqa: E402
from repro_torch.configs import starcoder2_3b as tsc  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config, tiny_config  # noqa: E402
from repro_torch.convert import params_from_reference, to_tensor  # noqa: E402
from repro_torch.launch import profile_serve as tprofile  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.decode import generate as tgenerate  # noqa: E402

ARCHS_RECURRENT = ["falcon-mamba-7b", "recurrentgemma-9b"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _cfgs(arch):
    return (dataclasses.replace(jtiny(arch), dtype=jnp.float32),
            dataclasses.replace(tiny_config(arch), dtype=torch.float32))


def _params(init, jc, seed, shift):
    """Reference mixer params, with the named leaves moved off their
    constant init; returned for both packages."""
    tree = {k: np.asarray(v) for k, v in
            jax.device_get(init(jax.random.PRNGKey(seed), jc)).items()}
    for i, name in enumerate(shift):
        tree[name] = tree[name] + 0.1 * _x(10 + i, *tree[name].shape)
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: to_tensor(v) for k, v in tree.items()})


# --------------------------------------------------------------------------
# configs and registry
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pair", [(jmamba, tmamba), (jrg, trg), (jsc, tsc)],
                         ids=["falcon-mamba-7b", "recurrentgemma-9b",
                              "starcoder2-3b"])
@pytest.mark.parametrize("which", ["CONFIG", "TINY"])
def test_config_field_equal_to_reference(pair, which):
    jc, tc = (getattr(m, which) for m in pair)
    ja, ta = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert ja.keys() == ta.keys()
    for f in ja:
        if f in ("dtype", "opt_state_dtype"):
            assert str(ta[f]).removeprefix("torch.") == jnp.dtype(ja[f]).name, f
        else:
            assert ta[f] == ja[f], f
    for prop in ("vocab_padded", "head_dim", "inner", "dtrank", "lru",
                 "n_super", "remainder", "sub_quadratic", "params_total"):
        v, w = getattr(jc, prop), getattr(tc, prop)
        assert (v() if callable(v) else v) == (w() if callable(w) else w), prop


def test_registry_resolves_the_three_ported_archs():
    # The name is older than the fourth arch, starcoder2-3b (training slice),
    # the two dense ones (tests/test_torch_dense.py) and the last four
    # (tests/test_torch_archs.py); all ten resolve now.
    assert {"falcon-mamba-7b", "qwen3-32b", "recurrentgemma-9b",
            "starcoder2-3b"} <= set(ARCHS) and len(ARCHS) == 10
    for name, mod in (("qwen3-32b", tqwen), ("falcon-mamba-7b", tmamba),
                      ("recurrentgemma-9b", trg), ("starcoder2-3b", tsc)):
        assert get_config(name) is mod.CONFIG and tiny_config(name) is mod.TINY
    assert trg.CONFIG.head_dim == 256 and trg.CONFIG.remainder == ("rglru", "rglru")


# --------------------------------------------------------------------------
# mixers
# --------------------------------------------------------------------------
MAMBA_SHIFT = ("conv_b", "dt_bias", "D")
RGLRU_SHIFT = ("conv_b", "log_lam")


def test_mamba_forward():
    jc, tc = _cfgs("falcon-mamba-7b")
    jp, tp = _params(JS.mamba_init, jc, 0, MAMBA_SHIFT)
    x = _x(0, 2, 9, jc.d_model)
    _close(TS.mamba_forward(tp, torch.from_numpy(x), tc),
           JS.mamba_forward(jp, jnp.asarray(x), jc))


@pytest.mark.parametrize("T", [2, 9])          # fewer and more steps than W-1
def test_mamba_prefill_state(T):
    jc, tc = _cfgs("falcon-mamba-7b")
    jp, tp = _params(JS.mamba_init, jc, 1, MAMBA_SHIFT)
    x = _x(1, 2, T, jc.d_model)
    want, jst = JT._mamba_prefill(jp, jnp.asarray(x), jc)
    got, st = TT._mamba_prefill(tp, torch.from_numpy(x), tc)
    _close(got, want)
    assert st.keys() == jst.keys() == {"conv", "h"}
    for k in st:
        _close(st[k], jst[k])


def test_mamba_decode():
    jc, tc = _cfgs("falcon-mamba-7b")
    jp, tp = _params(JS.mamba_init, jc, 2, MAMBA_SHIFT)
    cache = {"conv": _x(3, 2, jc.ssm_conv - 1, jc.inner),
             "h": _x(4, 2, jc.inner, jc.ssm_state)}
    x = _x(2, 2, 1, jc.d_model)
    want, jst = JS.mamba_decode(jp, jnp.asarray(x), jc,
                                {k: jnp.asarray(v) for k, v in cache.items()})
    got, st = TS.mamba_decode(tp, torch.from_numpy(x), tc,
                              {k: torch.from_numpy(v) for k, v in cache.items()})
    _close(got, want)
    for k in ("conv", "h"):
        _close(st[k], jst[k])


def test_rglru_forward():
    jc, tc = _cfgs("recurrentgemma-9b")
    jp, tp = _params(JR.rglru_init, jc, 3, RGLRU_SHIFT)
    x = _x(5, 2, 9, jc.d_model)
    _close(TR.rglru_forward(tp, torch.from_numpy(x), tc),
           JR.rglru_forward(jp, jnp.asarray(x), jc))


def test_rglru_decode():
    jc, tc = _cfgs("recurrentgemma-9b")
    jp, tp = _params(JR.rglru_init, jc, 4, RGLRU_SHIFT)
    cache = {"conv": _x(6, 2, TR.CONV_W - 1, jc.lru), "h": _x(7, 2, jc.lru)}
    x = _x(8, 2, 1, jc.d_model)
    want, jst = JR.rglru_decode(jp, jnp.asarray(x), jc,
                                {k: jnp.asarray(v) for k, v in cache.items()})
    got, st = TR.rglru_decode(tp, torch.from_numpy(x), tc,
                              {k: torch.from_numpy(v) for k, v in cache.items()})
    _close(got, want)
    for k in ("conv", "h"):
        _close(st[k], jst[k])


# --------------------------------------------------------------------------
# whole TINY models
# --------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS_RECURRENT)
def models(request):
    jc, tc = _cfgs(request.param)
    params = JT.init_params(jax.random.PRNGKey(0), jc)
    model = TT.Transformer(tc, device="cpu")
    model.load_state_dict(params_from_reference(jax.device_get(params), tc))
    return jc, params, model


def _tokens(seed, B, T, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)


def test_forward_matches_reference(models):
    jc, params, model = models
    toks = _tokens(0, 2, 12, jc.vocab)
    want, _ = JT.forward(params, jnp.asarray(toks), jc)
    with torch.inference_mode():
        got, _ = model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_prefill_matches_reference(models):
    """Logits and every cache entry; T=12 crosses recurrentgemma's window
    of 8, so its local layer's ring is rolled."""
    jc, params, model = models
    toks = _tokens(1, 2, 12, jc.vocab)
    want, jcache = JT.prefill(params, jnp.asarray(toks), jc, max_len=16)
    with torch.inference_mode():
        got, cache = model.prefill(torch.from_numpy(toks).long(), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    P = len(jc.pattern)
    for j, c in enumerate(cache):
        s, i = divmod(j, P)
        jc_j = (jax.tree.map(lambda a: a[s], jcache["blocks"][f"b{i}"])
                if s < jc.n_super else jcache[f"rem{j - jc.n_super * P}"])
        assert c.keys() == jc_j.keys(), j
        for k in c:
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jc_j[k]),
                                       atol=2e-4, rtol=2e-4, err_msg=f"{j}.{k}")


def test_decode_teacher_forced_matches_reference(models):
    jc, params, model = models
    B, S, EXTRA = 1, 8, 4
    toks = _tokens(2, B, S + EXTRA, jc.vocab)
    _, jcache = JT.prefill(params, jnp.asarray(toks[:, :S]), jc, max_len=S + EXTRA)
    with torch.inference_mode():
        _, tcache = model.prefill(torch.from_numpy(toks[:, :S]).long(), S + EXTRA)
        for i in range(EXTRA):
            cur = toks[:, S + i:S + i + 1]
            want, jcache = JT.decode_step(params, jcache, jnp.asarray(cur),
                                          jnp.int32(S + i), jc)
            got, tcache = model.decode_step(tcache, torch.from_numpy(cur).long(),
                                            S + i)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                                       rtol=5e-4, err_msg=f"step {i}")


@pytest.mark.parametrize("S", [6, 11])         # prompt inside / past the window
def test_local_window_ring_cache_long_decode(S):
    """Decode far past the window (total 20 > 2 x 8): the port's ring cache
    against the reference's full forward, as test_serve.py does."""
    jc, tc = _cfgs("recurrentgemma-9b")
    total = 20
    params = JT.init_params(jax.random.PRNGKey(0), jc)
    model = TT.Transformer(tc, device="cpu")
    model.load_state_dict(params_from_reference(jax.device_get(params), tc))
    toks = _tokens(4, 1, total, jc.vocab)
    full, _ = JT.forward(params, jnp.asarray(toks), jc)
    with torch.inference_mode():
        _, cache = model.prefill(torch.from_numpy(toks[:, :S]).long(), total)
        for i in range(S, total):
            logits, cache = model.decode_step(
                cache, torch.from_numpy(toks[:, i:i + 1]).long(), i)
            np.testing.assert_allclose(logits[:, 0].numpy(), np.asarray(full[:, i]),
                                       atol=1e-3, rtol=1e-3, err_msg=f"pos {i}")


def test_generate_tokens_equal_reference(models):
    jc, params, model = models
    prompt = _tokens(3, 2, 6, jc.vocab)
    want = jgenerate(params, jc, jnp.asarray(prompt), steps=8)
    got = tgenerate(model, torch.from_numpy(prompt).long(), steps=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS_RECURRENT)
def test_init_params_matches_reference_tree(arch):
    """Same keys, shapes and dtypes as the reference's tree, and its
    constants in the recurrent mixers."""
    cfg = tiny_config(arch)                              # bf16, as the reference
    model = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = params_from_reference(
        jax.device_get(JT.init_params(jax.random.PRNGKey(0), jtiny(arch))), cfg)
    sd = model.state_dict()
    assert sd.keys() == ref.keys()
    for k, v in sd.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k
        if k.split(".")[-1] in ("dt_bias", "A_log", "D", "conv_b", "log_lam"):
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("arch", ARCHS_RECURRENT)
def test_launch_serve_cpu_runs(arch, capsys):
    res = tserve.run(["--arch", arch, "--tiny", "--batch", "2",
                      "--prompt-len", "10", "--steps", "4", "--device", "cpu"])
    assert tuple(res.tokens.shape) == (2, 4)
    out = capsys.readouterr().out
    assert f"arch={res.cfg.name}" in out
    assert "prefill:" in out and "ms/step" in out and "tok/s" in out


@pytest.mark.parametrize("arch", ARCHS_RECURRENT)
def test_profile_serve_cpu_runs(arch, capsys):
    rc = tprofile.main(["--arch", arch, "--tiny", "--batch", "2",
                        "--prompt-len", "10", "--steps", "3", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "== prefill: wall" in out and "== decode (2 steps): wall" in out

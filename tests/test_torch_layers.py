"""Port layers and configs against the JAX reference, in f32 at 1e-5.

Parameters come from the reference's own ``*_init`` functions and are
converted with ``repro_torch.convert``; activations are seeded numpy.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import qwen3_32b as jqwen  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import qwen3_32b as tqwen  # noqa: E402
from repro_torch.configs.registry import get_config, tiny_config  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(**kw):
    jc = dataclasses.replace(jqwen.TINY, dtype=jnp.float32, **kw)
    tc = dataclasses.replace(tqwen.TINY, dtype=torch.float32, **kw)
    return jc, tc


def _tparams(tree):
    return {k: to_tensor(np.asarray(v)) for k, v in tree.items()}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["CONFIG", "TINY"])
def test_qwen3_config_field_equal_to_reference(which):
    jc, tc = getattr(jqwen, which), getattr(tqwen, which)
    ja, ta = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert ja.keys() == ta.keys()
    for f in ja:
        if f in ("dtype", "opt_state_dtype"):
            assert str(ta[f]).removeprefix("torch.") == jnp.dtype(ja[f]).name, f
        else:
            assert ta[f] == ja[f], f
    for prop in ("vocab_padded", "head_dim", "n_super", "remainder",
                 "sub_quadratic", "params_total", "params_active"):
        v = getattr(jc, prop)
        assert (v() if callable(v) else v) == (
            getattr(tc, prop)() if callable(getattr(tc, prop)) else getattr(tc, prop)), prop
    assert tc.dtype == torch.bfloat16 and tc.opt_state_dtype == torch.float32


def test_registry_ports_qwen3_and_names_the_rest():
    assert get_config("qwen3-32b") is tqwen.CONFIG
    assert tiny_config("qwen3-32b") is tqwen.TINY
    assert tqwen.CONFIG.vocab_padded == 152064
    # The rest resolve to their own configs (tests/test_torch_archs.py).
    assert get_config("whisper-small").kind == "encdec"
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    jc, tc = _cfgs(norm=norm)
    p = {"scale": 1.0 + 0.1 * _x(1, jc.d_model)}
    if norm == "layernorm":
        p["bias"] = 0.1 * _x(2, jc.d_model)
    x = _x(0, 2, 5, jc.d_model)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), jc)
    _close(TL.apply_norm(_tparams(p), torch.from_numpy(x), tc), want)


@pytest.mark.parametrize("pos2d", [False, True])
def test_rope(pos2d):
    x = _x(0, 2, 7, 3, 16)
    pos = np.arange(7) + 5
    if pos2d:
        pos = np.stack([pos, pos + 100])
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6), want)


def test_qk_normalize():
    x, s = _x(0, 2, 5, 4, 16), 1.0 + _x(1, 16)
    want = JL._qk_normalize(jnp.asarray(x), jnp.asarray(s))
    _close(TL._qk_normalize(torch.from_numpy(x), torch.from_numpy(s)), want)


def _attn_params(jc, seed=0):
    tree = jax.device_get(JL.attn_init(jax.random.PRNGKey(seed), jc))
    tree = {k: np.asarray(v) for k, v in tree.items()}
    # Norm scales start at 1 and biases at 0: move them off so they count.
    for i, name in enumerate(("q_norm", "k_norm", "bq", "bk", "bv")):
        if name in tree:
            tree[name] = tree[name] + 0.1 * _x(5 + i, *tree[name].shape)
    return {k: jnp.asarray(v) for k, v in tree.items()}, _tparams(tree)


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_attn_qkv(qkv_bias, cross):
    jc, tc = _cfgs(qkv_bias=qkv_bias)
    jp, tp = _attn_params(jc)
    x = _x(0, 2, 6, jc.d_model)
    pos = np.arange(6)
    src = _x(1, 2, 9, jc.d_model) if cross else None
    want = JL.attn_qkv(jp, jnp.asarray(x), jc, jnp.asarray(pos),
                       None if src is None else jnp.asarray(src))
    got = TL.attn_qkv(tp, torch.from_numpy(x), tc, torch.from_numpy(pos),
                      None if src is None else torch.from_numpy(src))
    for g, w in zip(got, want):
        _close(g, w)


def test_attn_forward():
    jc, tc = _cfgs()
    jp, tp = _attn_params(jc, 1)
    x = _x(1, 2, 9, jc.d_model)
    want = JL.attn_forward(jp, jnp.asarray(x), jc)
    _close(TL.attn_forward(tp, torch.from_numpy(x), tc), want)


@pytest.mark.parametrize("index,window,ring", [
    (0, 0, False), (5, 0, False), (11, 0, False), (9, 4, False),
    (5, 0, True), (17, 0, True)])
def test_attn_decode(index, window, ring):
    jc, tc = _cfgs()
    jp, tp = _attn_params(jc, 2)
    S, K, hd = 12, jc.n_kv_heads, jc.head_dim
    ck, cv = _x(3, 2, S, K, hd), _x(4, 2, S, K, hd)
    x = _x(2, 2, 1, jc.d_model)
    want = JL.attn_decode(jp, jnp.asarray(x), jc, jnp.asarray(ck),
                          jnp.asarray(cv), jnp.int32(index), window=window,
                          ring=ring)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = TL.attn_decode(tp, torch.from_numpy(x), tc, tk, tv, index,
                         window=window, ring=ring)
    for g, w in zip(got, want):
        _close(g, w)
    assert got[1] is tk and got[2] is tv          # updated in place


@pytest.mark.parametrize("ffn", ["swiglu", "geglu", "gelu"])
def test_ffn_forward(ffn):
    jc, tc = _cfgs(ffn=ffn)
    tree = jax.device_get(JL.ffn_init(jax.random.PRNGKey(3), jc))
    x = _x(0, 2, 5, jc.d_model)
    want = JL.ffn_forward(tree, jnp.asarray(x), jc)
    _close(TL.ffn_forward(_tparams(tree), torch.from_numpy(x), tc), want)


def test_embed_and_unembed_with_padded_vocab():
    jc, tc = _cfgs()
    assert jc.vocab_padded > jc.vocab
    tree = jax.device_get(JL.embed_init(jax.random.PRNGKey(4), jc))
    tp = _tparams(tree)
    toks = np.random.default_rng(0).integers(0, jc.vocab, (2, 6))
    _close(TL.embed(tp, torch.from_numpy(toks), tc),
           JL.embed(tree, jnp.asarray(toks), jc))
    x = _x(1, 2, 6, jc.d_model)
    got = TL.unembed(tp, torch.from_numpy(x), tc)
    _close(got, JL.unembed(tree, jnp.asarray(x), jc))
    assert torch.all(got[..., jc.vocab:] < -1e29)

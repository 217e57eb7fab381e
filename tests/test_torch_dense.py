"""The two dense configs of the port (qwen2-72b, llama3-405b) against the
JAX reference, in f32 on the CPU.

Both are ``("attn",)`` decoders built from layers the port already has:
qwen2 adds q/k/v biases, llama3 a bf16 optimizer state (its train step is
in ``tests/test_torch_train.py``).  Configs are field-equal to the
reference's; TINY models load the reference's parameters (biases moved off
their zero init so that they count) through ``params_from_reference`` and
must give the reference's forward logits within 2e-5 and its greedy tokens
exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import llama3_405b as jllama  # noqa: E402
from repro.configs import qwen2_72b as jqwen2  # noqa: E402
from repro.configs.registry import tiny_config as jtiny  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.decode import generate as jgenerate  # noqa: E402
from repro_torch.configs import llama3_405b as tllama  # noqa: E402
from repro_torch.configs import qwen2_72b as tqwen2  # noqa: E402
from repro_torch.configs.registry import (ARCHS, NOT_YET_PORTED,  # noqa: E402
                                          get_config, tiny_config)
from repro_torch.convert import params_from_reference, reference_leaf  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.decode import generate as tgenerate  # noqa: E402

DENSE = ["qwen2-72b", "llama3-405b"]
PAIRS = {"qwen2-72b": (jqwen2, tqwen2), "llama3-405b": (jllama, tllama)}


@pytest.mark.parametrize("arch", DENSE)
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
    for prop in ("vocab_padded", "head_dim", "n_super", "remainder",
                 "params_total"):
        v, w = getattr(jc, prop), getattr(tc, prop)
        assert (v() if callable(v) else v) == (w() if callable(w) else w), prop


def test_registry_resolves_six_archs():
    # The six decoder archs of the earlier slices; the other four resolve
    # too since the MoE / encoder-decoder / vision slice
    # (tests/test_torch_archs.py).
    assert {"falcon-mamba-7b", "llama3-405b", "qwen2-72b", "qwen3-32b",
            "recurrentgemma-9b", "starcoder2-3b"} <= set(ARCHS)
    for arch in DENSE:
        assert get_config(arch) is PAIRS[arch][1].CONFIG
        assert tiny_config(arch) is PAIRS[arch][1].TINY
    assert NOT_YET_PORTED == ()
    assert get_config("llama3-405b").opt_state_dtype == torch.bfloat16
    assert get_config("qwen2-72b").qkv_bias


@pytest.fixture(scope="module", params=DENSE)
def models(request):
    """The reference's TINY f32 parameters, q/k/v biases (qwen2) moved off
    their zero init, and the port's model loaded from them."""
    arch = request.param
    jc = dataclasses.replace(jtiny(arch), dtype=jnp.float32)
    tc = dataclasses.replace(tiny_config(arch), dtype=torch.float32)
    params = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jc))
    if jc.qkv_bias:
        attn = params["blocks"]["b0"]["mixer"]
        r = np.random.default_rng(1)
        for k in ("bq", "bk", "bv"):
            attn[k] = np.asarray(attn[k]) + 0.5 * r.standard_normal(
                attn[k].shape).astype(np.float32)
    model = TT.Transformer(tc, device="cpu")
    model.load_state_dict(params_from_reference(params, tc))
    return arch, jc, tc, jax.tree_util.tree_map(jnp.asarray, params), model


def test_params_from_reference_covers_the_qkv_biases(models):
    arch, jc, tc, params, model = models
    sd = model.state_dict()
    names = [n for n in sd if n.rsplit(".", 1)[-1] in ("bq", "bk", "bv")]
    if not tc.qkv_bias:
        assert names == []
        return
    assert len(names) == 3 * tc.n_layers
    for n in names:
        want = reference_leaf(jax.device_get(params), n, tc)
        assert np.abs(want).max() > 0.1, n            # moved off zero
        np.testing.assert_array_equal(sd[n].numpy(), want, err_msg=n)


def test_forward_logits_match_reference(models):
    arch, jc, tc, params, model = models
    toks = np.random.default_rng(2).integers(0, jc.vocab, (2, 12)).astype(np.int32)
    want, _ = JT.forward(params, jnp.asarray(toks), jc)
    with torch.inference_mode():
        got, _ = model(torch.from_numpy(toks).long())
    V = jc.vocab
    np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(want)[..., :V],
                               atol=2e-5, rtol=2e-5)


def test_greedy_tokens_equal_reference(models):
    arch, jc, tc, params, model = models
    prompt = np.random.default_rng(3).integers(0, jc.vocab, (2, 6)).astype(np.int32)
    want = jgenerate(params, jc, jnp.asarray(prompt), steps=8)
    got = tgenerate(model, torch.from_numpy(prompt).long(), steps=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

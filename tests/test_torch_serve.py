"""Port serving path against the JAX reference on qwen3-32b TINY in f32.

The reference's parameters (``T.init_params``) are loaded into the port
through ``params_from_reference``; tolerances are those of
``tests/test_serve.py`` (2e-4 for logits, 5e-4 for teacher-forced decode)
and generated tokens must be identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import tiny_config as jtiny  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.decode import generate as jgenerate  # noqa: E402
from repro_torch.configs.registry import tiny_config as ttiny  # noqa: E402
from repro_torch.convert import params_from_reference, to_tensor  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.decode import generate as tgenerate  # noqa: E402

ARCH = "qwen3-32b"


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jtiny(ARCH), dtype=jnp.float32)
    tc = dataclasses.replace(ttiny(ARCH), dtype=torch.float32)
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
        got, aux = model(torch.from_numpy(toks).long())
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_prefill_matches_reference(models):
    jc, params, model = models
    toks = _tokens(1, 2, 12, jc.vocab)
    want, _ = JT.prefill(params, jnp.asarray(toks), jc, max_len=16)
    with torch.inference_mode():
        got, cache = model.prefill(torch.from_numpy(toks).long(), 16)
    assert got.shape == (2, 1, jc.vocab_padded) and len(cache) == jc.n_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


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


def test_generate_tokens_equal_reference(models):
    jc, params, model = models
    prompt = _tokens(3, 2, 6, jc.vocab)
    want = jgenerate(params, jc, jnp.asarray(prompt), steps=8)
    got = tgenerate(model, torch.from_numpy(prompt).long(), steps=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_params_matches_reference_tree():
    """Same keys, shapes, dtypes and init scale as the reference's tree."""
    cfg = ttiny(ARCH)                                   # bf16, as in the reference
    gen = torch.Generator().manual_seed(0)
    model = TT.init_params(cfg, gen, device="cpu")
    ref = params_from_reference(
        jax.device_get(JT.init_params(jax.random.PRNGKey(0), jtiny(ARCH))), cfg)
    sd = model.state_dict()
    assert sd.keys() == ref.keys()
    for k, v in sd.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k
    std = sd["layers.0.ffn.wo"].float().std().item()
    assert abs(std * cfg.d_ff ** 0.5 - 1.0) < 0.1
    assert torch.all(sd["layers.1.mixer.q_norm"] == 1)


def test_bf16_conversion_is_bit_exact():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 37, dtype=np.float32),
                               jnp.bfloat16))
    t = to_tensor(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))


def test_unported_patterns_raise():
    # Block types, kinds and frontends the reference does not have.
    for kw in (dict(pattern=("attn", "moe")), dict(kind="bogus"),
               dict(frontend="lidar")):
        with pytest.raises(NotImplementedError):
            TT.Transformer(dataclasses.replace(ttiny(ARCH), **kw), device="cpu")
    # Encoder-decoders, the vision frontend and experts build since the
    # MoE / encoder-decoder / vision slice.
    for kw in (dict(kind="encdec", enc_layers=1), dict(frontend="vision"),
               dict(moe_experts=4, moe_topk=2)):
        TT.Transformer(dataclasses.replace(ttiny(ARCH), **kw), device="meta")


def test_launch_serve_cpu_runs(capsys):
    rc = tserve.main(["--arch", ARCH, "--tiny", "--batch", "2",
                      "--prompt-len", "8", "--steps", "4", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "prefill:" in out and "ms/step" in out and "tok/s" in out


def test_launch_serve_cuda_without_card_raises():
    """No hidden fallback: asking for the card without one is an error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", ARCH, "--tiny", "--device", "cuda"])


def test_profile_serve_cpu_runs(capsys):
    from repro_torch.launch import profile_serve
    rc = profile_serve.main(["--arch", ARCH, "--tiny", "--batch", "2",
                             "--prompt-len", "8", "--steps", "3",
                             "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "== prefill: wall" in out and "== decode (2 steps): wall" in out

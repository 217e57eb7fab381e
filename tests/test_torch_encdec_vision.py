"""The encoder-decoder (whisper-small) and the vision prefix (paligemma-3b)
of the port against the JAX reference, in f32 on the CPU.

Both packages get the reference's TINY parameters (through
``repro_torch.convert``) and the same seeded numpy tokens and stub frames
or patches.  Held: forward logits; prefill logits and the cache it builds
(whisper's cross K/V, paligemma's K/V over patches and prompt); teacher-
forced decode steps; greedy tokens; one train step with 1 and 2
microbatches, at the tolerances of ``tests/test_torch_serve.py`` and
``tests/test_torch_train.py``.

paligemma's decode is held against the reference's ``decode_step`` with a
cache of P + Tp + steps positions and the first index P + Tp.  The
reference's own serving loop (``repro.serve.decode.generate``) sizes the
cache Tp + steps and starts at Tp, ignoring the P patch positions that its
prefill prepends; one test pins that defect.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import paligemma_3b as jpali  # noqa: E402
from repro.configs import whisper_small as jwhisper  # noqa: E402
from repro.configs.registry import tiny_config as jtiny  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.decode import generate as jgenerate  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch.configs import paligemma_3b as tpali  # noqa: E402
from repro_torch.configs import whisper_small as twhisper  # noqa: E402
from repro_torch.configs.registry import tiny_config  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference, reference_leaf,
                                 to_tensor)
from repro_torch.data.pipeline import synthetic_batch  # noqa: E402
from repro_torch.models import frontends  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.decode import generate as tgenerate  # noqa: E402
from repro_torch.serve.decode import prefix_len  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

ARCHS = ["whisper-small", "paligemma-3b"]
PAIRS = {"whisper-small": (jwhisper, twhisper), "paligemma-3b": (jpali, tpali)}
TOL = dict(atol=2e-4, rtol=2e-4)


def _extra(cfg, B, seed):
    """{"frames"} or {"patches"} as seeded numpy, N(0,1)*0.02."""
    key, n = (("frames", cfg.enc_len) if cfg.frontend == "audio"
              else ("patches", cfg.vision_patches))
    rng = np.random.default_rng(seed)
    return {key: (rng.standard_normal((B, n, cfg.d_model)) * 0.02).astype(np.float32)}


def _tokens(seed, B, T, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("arch", ARCHS)
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
    for prop in ("vocab_padded", "head_dim", "n_super", "params_total"):
        v, w = getattr(jc, prop), getattr(tc, prop)
        assert (v() if callable(v) else v) == (w() if callable(w) else w), prop


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_stubs_shapes_and_seed(arch):
    cfg = tiny_config(arch)
    a = frontends.extra_inputs(cfg, 3, torch.Generator().manual_seed(1), "cpu")
    b = frontends.extra_inputs(cfg, 3, torch.Generator().manual_seed(1), "cpu")
    (key, x), = a.items()
    n = cfg.enc_len if cfg.frontend == "audio" else cfg.vision_patches
    assert key == ("frames" if cfg.frontend == "audio" else "patches")
    assert x.shape == (3, n, cfg.d_model) and x.dtype == cfg.dtype
    assert torch.equal(x, b[key])
    assert 0.01 < x.float().std().item() < 0.03
    assert frontends.extra_inputs(tiny_config("qwen3-32b"), 3,
                                  torch.Generator(), "cpu") == {}


@functools.cache
def _models(arch):
    jc = dataclasses.replace(jtiny(arch), dtype=jnp.float32)
    tc = dataclasses.replace(tiny_config(arch), dtype=torch.float32)
    params = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jc))
    model = TT.Transformer(tc, device="cpu")
    model.load_state_dict(params_from_reference(params, tc))
    return arch, jc, tc, jax.tree.map(jnp.asarray, params), model


@pytest.fixture(params=ARCHS)
def models(request):
    return _models(request.param)


def test_params_from_reference_covers_the_new_leaves(models):
    arch, jc, tc, params, model = models
    names = [n for n, _ in model.named_parameters()]
    host = jax.device_get(params)
    if arch == "whisper-small":
        enc = [n for n in names if n.startswith("enc_layers.")]
        assert len(enc) == tc.enc_layers * 10   # norm1, norm2 2 each, mixer 4, ffn 2
        assert sum(".cross." in n for n in names) == 4 * tc.n_layers
        assert sum(".norm_c." in n for n in names) == 2 * tc.n_layers
        assert "enc_final_norm.scale" in names
    else:
        assert "patch_proj" in names
    for n in names:
        np.testing.assert_array_equal(model.get_parameter(n).detach().numpy(),
                                      reference_leaf(host, n, tc), err_msg=n)


def test_forward_logits_match_reference(models):
    arch, jc, tc, params, model = models
    toks = _tokens(2, 2, 12, jc.vocab)
    ex = _extra(jc, 2, 3)
    want, _ = JT.forward(params, jnp.asarray(toks), jc, **_j(ex))
    with torch.inference_mode():
        got, aux = model(torch.from_numpy(toks).long(), **_t(ex))
    P = jc.vision_patches if arch == "paligemma-3b" else 0
    assert got.shape == (2, P + 12, jc.vocab_padded) and float(aux) == 0.0
    V = jc.vocab
    np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(want)[..., :V],
                               **TOL)
    # The stub inputs matter: other frames / patches, other logits.
    with torch.inference_mode():
        other, _ = model(torch.from_numpy(toks).long(), **_t(_extra(jc, 2, 4)))
    assert (other - got)[..., :V].abs().max() > 1e-3


def test_prefill_logits_and_cache_match_reference(models):
    arch, jc, tc, params, model = models
    B, Tp, steps = 2, 8, 4
    toks = _tokens(5, B, Tp, jc.vocab)
    ex = _extra(jc, B, 6)
    P = jc.vision_patches if arch == "paligemma-3b" else 0
    max_len = P + Tp + steps
    want, jcache = JT.prefill(params, jnp.asarray(toks), jc, max_len, **_j(ex))
    with torch.inference_mode():
        got, cache = model.prefill(torch.from_numpy(toks).long(), max_len,
                                   **_t(ex))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(cache) == tc.n_layers
    names = ("ck", "cv", "k", "v") if arch == "whisper-small" else ("k", "v")
    for i, c in enumerate(cache):
        for name in names:
            ref = np.asarray(jcache["blocks"]["b0"][name][i])
            assert c[name].shape == ref.shape, (i, name)
            np.testing.assert_allclose(c[name].numpy(), ref, err_msg=f"{i} {name}",
                                       **TOL)
        if arch == "whisper-small":
            assert c["ck"].shape == (B, tc.enc_len, tc.n_heads, tc.head_dim)


def test_decode_teacher_forced_matches_reference(models):
    """Each decode step's logits against the reference's ``decode_step`` at
    the same index; for paligemma the cache is P + Tp + steps long and the
    first index P + Tp."""
    arch, jc, tc, params, model = models
    B, Tp, EXTRA = 2, 8, 3
    toks = _tokens(7, B, Tp + EXTRA, jc.vocab)
    ex = _extra(jc, B, 8)
    P = jc.vision_patches if arch == "paligemma-3b" else 0
    max_len = P + Tp + EXTRA
    _, jcache = JT.prefill(params, jnp.asarray(toks[:, :Tp]), jc, max_len,
                           **_j(ex))
    with torch.inference_mode():
        _, tcache = model.prefill(torch.from_numpy(toks[:, :Tp]).long(),
                                  max_len, **_t(ex))
        for i in range(EXTRA):
            cur = toks[:, Tp + i:Tp + i + 1]
            want, jcache = JT.decode_step(params, jcache, jnp.asarray(cur),
                                          jnp.int32(P + Tp + i), jc)
            got, tcache = model.decode_step(tcache, torch.from_numpy(cur).long(),
                                            P + Tp + i)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                                       rtol=5e-4, err_msg=f"step {i}")


def _greedy_by_forward(params, jc, prompt, steps, ex):
    """Greedy tokens from the reference's full ``forward`` on the growing
    sequence: what a correct serving loop must give."""
    seq, out = prompt, []
    for _ in range(steps):
        logits, _ = JT.forward(params, jnp.asarray(seq), jc, **_j(ex))
        tok = np.asarray(jnp.argmax(logits[:, -1, :jc.vocab], axis=-1)).astype(np.int32)
        out.append(tok)
        seq = np.concatenate([seq, tok[:, None]], axis=1)
    return np.stack(out, axis=1)


def test_generate_equals_greedy_decoding_by_forward(models):
    arch, jc, tc, params, model = models
    prompt = _tokens(9, 2, 8, jc.vocab)
    ex = _extra(jc, 2, 10)
    want = _greedy_by_forward(params, jc, prompt, 6, ex)
    got = tgenerate(model, torch.from_numpy(prompt).long(), 6, **_t(ex))
    np.testing.assert_array_equal(got.numpy(), want)
    assert prefix_len(model, **_t(ex)) == (jc.vision_patches
                                           if arch == "paligemma-3b" else 0)
    if arch == "whisper-small":     # the reference's loop is right here
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jgenerate(params, jc, jnp.asarray(prompt), 6,
                                              **_j(ex))))


def test_reference_serving_ignores_the_patch_prefix():
    """The reference's ``generate`` with ``patches`` sizes the cache Tp +
    steps and decodes from index Tp, although its prefill put P patches in
    front: the first decoded token overwrites a prompt position's K/V and
    takes its RoPE position.  Its decode logits then miss ``forward``'s on
    the same sequence by more than 0.1, and its tokens leave greedy decoding
    by ``forward``; with the cache P + Tp + steps long and the index at
    P + Tp they agree within 1e-4.  The port's ``generate`` does the latter."""
    arch, jc, tc, params, model = _models("paligemma-3b")
    B, Tp, steps = 2, 8, 6
    P = jc.vision_patches
    prompt = _tokens(9, B, Tp, jc.vocab)
    ex = _extra(jc, B, 10)
    nxt = _tokens(11, B, 1, jc.vocab)
    full, _ = JT.forward(params, jnp.asarray(np.concatenate([prompt, nxt], 1)),
                         jc, **_j(ex))
    want = np.asarray(full)[:, -1:, :jc.vocab]
    errs = {}
    for name, max_len, index in (("reference", Tp + steps, Tp),
                                 ("corrected", P + Tp + steps, P + Tp)):
        _, cache = JT.prefill(params, jnp.asarray(prompt), jc, max_len, **_j(ex))
        logits, _ = JT.decode_step(params, cache, jnp.asarray(nxt),
                                   jnp.int32(index), jc)
        errs[name] = np.abs(np.asarray(logits)[..., :jc.vocab] - want).max()
    assert errs["reference"] > 1e-1, errs
    assert errs["corrected"] < 1e-4, errs
    greedy = _greedy_by_forward(params, jc, prompt, steps, ex)
    ref_tokens = np.asarray(jgenerate(params, jc, jnp.asarray(prompt), steps,
                                      **_j(ex)))
    assert not np.array_equal(ref_tokens, greedy)
    port = tgenerate(model, torch.from_numpy(prompt).long(), steps, **_t(ex))
    np.testing.assert_array_equal(port.numpy(), greedy)


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, M):
    """One step from the same state and batch (tokens, labels and the stub
    frames / patches): loss, CE, grad norm, updated parameters and both
    moments (``weight_decay=0``, see ``tests/test_torch_train.py``)."""
    jc = dataclasses.replace(jtiny(arch), dtype=jnp.float32)
    tc = dataclasses.replace(tiny_config(arch), dtype=torch.float32)
    jopt = JO.AdamWConfig(state_dtype=jc.opt_state_dtype, weight_decay=0.0)
    topt = TO.AdamWConfig(state_dtype=tc.opt_state_dtype, weight_decay=0.0)
    jstate = JTS.train_state_init(jax.random.PRNGKey(0), jc, jopt)
    host = jax.device_get(jstate)
    model = TT.Transformer(tc, device="cpu")
    model.load_state_dict(params_from_reference(host["params"], tc))
    tstate = {"params": model.requires_grad_(True),
              "opt": opt_state_from_reference(host["opt"], tc),
              "step": to_tensor(np.asarray(host["step"]))}
    toks = _tokens(5, 4, 16, jc.vocab)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             **_extra(jc, 4, 12)}
    jnew, jm = jax.jit(JTS.make_train_step(jc, jopt, num_microbatches=M))(
        jstate, _j(batch))
    tb = {k: (torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v)) for k, v in batch.items()}
    tnew, tm = make_train_step(tc, topt, num_microbatches=M)(tstate, tb)
    jnew = jax.device_get(jnew)
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    for n, p in tnew["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   reference_leaf(jnew["params"], n, tc),
                                   err_msg=n, atol=2e-4, rtol=2e-4)
        for mom in ("m", "v"):
            np.testing.assert_allclose(tnew["opt"][mom][n].numpy(),
                                       reference_leaf(jnew["opt"][mom], n, tc),
                                       err_msg=f"{mom} {n}", atol=2e-4, rtol=2e-4)


def test_encoder_remat_gives_the_same_gradients():
    """Checkpointed encoder layers and super-blocks against none."""
    base = dataclasses.replace(tiny_config("whisper-small"), dtype=torch.float32)
    batch = synthetic_batch(3, base, 2, 10, "cpu")
    assert batch["frames"].shape == (2, base.enc_len, base.d_model)
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        model.requires_grad_(True)
        logits, _ = model(batch["tokens"], frames=batch["frames"])
        loss = logits[..., :cfg.vocab].logsumexp(-1).mean()
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
    for g, r in zip(grads[True], grads[False]):
        torch.testing.assert_close(g, r, atol=1e-6, rtol=1e-5)
    assert all(g.abs().max() > 0 for g in grads[True])

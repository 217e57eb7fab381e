"""Port training path against the JAX reference, in f32 on the CPU.

The first four tests mirror ``tests/test_train.py`` case for case on the
port alone (starcoder2-3b TINY).  The parity tests start both packages from
the reference's parameters and AdamW state (``repro_torch.convert``), feed
them one seeded numpy batch and compare one ``make_train_step``: loss and
grad norm within 1e-5, updated parameters and both moments within 2e-4 (the
reference's own accumulation tolerance, ``tests/test_train.py``), at the
reference tests' optimizer (``opt_for``: ``AdamWConfig(state_dtype=...)``,
lr 3e-4) with ``weight_decay=0``.  The reference decays the stacked per-layer
vectors that the port does not; one test pins that difference at the default
``weight_decay=0.1``.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import tiny_config as jtiny  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch.configs.registry import tiny_config  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference, reference_leaf,
                                 reference_path, to_tensor)
from repro_torch.data.pipeline import synthetic_batch  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train.train_step import (loss_fn, make_train_step,  # noqa: E402
                                          train_state_init)

ARCH = "starcoder2-3b"
CFG = dataclasses.replace(tiny_config(ARCH), dtype=torch.float32)
TOL = dict(atol=2e-4, rtol=2e-4)


def _batch(seed, B=4, S=16, cfg=CFG):
    return synthetic_batch(seed, cfg, B, S, "cpu")


def _state(opt, seed=0, cfg=CFG):
    return train_state_init(torch.Generator().manual_seed(seed), cfg, opt, "cpu")


def _leaves(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


# --------------------------------------------------------------------------
# tests/test_train.py, case for case
# --------------------------------------------------------------------------
def test_loss_decreases_memorizing_one_batch():
    opt = TO.AdamWConfig(lr=3e-3)
    state = _state(opt)
    step = make_train_step(CFG, opt)
    batch = _batch(1)
    losses = []
    for _ in range(25):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < 0.5 * losses[0], losses[::6]
    assert all(np.isfinite(losses))


def test_grad_accumulation_matches_single_batch():
    opt = TO.AdamWConfig(state_dtype=CFG.opt_state_dtype)
    batch = _batch(2, B=4)
    s1, m1 = make_train_step(CFG, opt, num_microbatches=1)(_state(opt), batch)
    s2, m2 = make_train_step(CFG, opt, num_microbatches=2)(_state(opt), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               atol=1e-5, rtol=1e-5)
    p2 = dict(s2["params"].named_parameters())
    for n, a in s1["params"].named_parameters():
        np.testing.assert_allclose(a.detach().numpy(), p2[n].detach().numpy(),
                                   **TOL)


def test_adamw_updates_every_param_and_step():
    opt = TO.AdamWConfig(state_dtype=CFG.opt_state_dtype)
    state = _state(opt)
    before = _leaves(state["params"])
    step0 = int(state["step"])
    state2, metrics = make_train_step(CFG, opt)(state, _batch(3))
    assert int(state2["step"]) == step0 + 1 and int(state2["opt"]["step"]) == 1
    changed = [not torch.allclose(before[n], p)
               for n, p in state2["params"].named_parameters()]
    assert all(changed), f"{sum(changed)}/{len(changed)} leaves updated"
    assert "grad_norm" in metrics and "loss" in metrics


def test_loss_fn_label_masking():
    model = _state(TO.AdamWConfig())["params"]
    batch = _batch(4)
    with torch.no_grad():
        l_full, _ = loss_fn(model, batch, CFG)
        masked = dict(batch)
        masked["labels"] = batch["labels"].clone()
        masked["labels"][:, ::2] = -1              # mask half
        l_mask, _ = loss_fn(model, masked, CFG)
    assert np.isfinite(float(l_mask))
    assert abs(float(l_mask) - float(l_full)) > 1e-6


# --------------------------------------------------------------------------
# parity with the reference
# --------------------------------------------------------------------------
def _np_batch(seed, vocab, B=4, S=16):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _both_states(arch, wd, seed=0):
    """One reference train state, and the port's state loaded from it."""
    jc = dataclasses.replace(jtiny(arch), dtype=jnp.float32)
    tc = dataclasses.replace(tiny_config(arch), dtype=torch.float32)
    jopt = JO.AdamWConfig(state_dtype=jc.opt_state_dtype, weight_decay=wd)
    topt = TO.AdamWConfig(state_dtype=tc.opt_state_dtype, weight_decay=wd)
    jstate = JTS.train_state_init(jax.random.PRNGKey(seed), jc, jopt)
    host = jax.device_get(jstate)
    model = TT.Transformer(tc, device="cpu")
    model.load_state_dict(params_from_reference(host["params"], tc))
    tstate = {"params": model.requires_grad_(True),
              "opt": opt_state_from_reference(host["opt"], tc),
              "step": to_tensor(np.asarray(host["step"]))}
    return jc, tc, jopt, topt, jstate, tstate


def _one_step(arch, M, wd, batch_seed=5):
    jc, tc, jopt, topt, jstate, tstate = _both_states(arch, wd)
    batch = _np_batch(batch_seed, jc.vocab)
    before = _leaves(tstate["params"])
    jnew, jm = jax.jit(JTS.make_train_step(jc, jopt, num_microbatches=M))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = make_train_step(tc, topt, num_microbatches=M)(
        tstate, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    return tc, before, jax.device_get(jnew), jm, tnew, tm


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen3-32b",
                                  "falcon-mamba-7b", "recurrentgemma-9b"])
def test_train_step_matches_reference(arch, M):
    tc, _, jnew, jm, tnew, tm = _one_step(arch, M, wd=0.0)
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    assert int(tnew["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    for n, p in tnew["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   reference_leaf(jnew["params"], n, tc),
                                   err_msg=n, **TOL)
        for mom in ("m", "v"):
            np.testing.assert_allclose(tnew["opt"][mom][n].numpy(),
                                       reference_leaf(jnew["opt"][mom], n, tc),
                                       err_msg=f"{mom} {n}", **TOL)


def test_weight_decay_differs_from_reference_only_on_stacked_vectors():
    """The reference decays ``p.ndim >= 2`` leaves of its stacked tree, so
    its per-layer norm scales and biases (2-d there) lose an extra
    ``lr * wd * p``; the port decays matrices only.  Everything else agrees."""
    opt = TO.AdamWConfig()
    tc, before, jnew, _, tnew, _ = _one_step(ARCH, 1, wd=opt.weight_decay)
    stacked_vectors = 0
    for n, p in tnew["params"].named_parameters():
        got = p.detach().numpy()
        want = reference_leaf(jnew["params"], n, tc)
        path, index = reference_path(n, tc)
        if p.ndim == 1 and index is not None:     # a vector of a stacked block
            extra = opt.lr * opt.weight_decay * before[n].numpy()
            np.testing.assert_allclose(got - want, extra, atol=1e-6, rtol=0,
                                       err_msg=n)
            stacked_vectors += 1
        else:                                     # matrices, final_norm
            np.testing.assert_allclose(got, want, err_msg=n, **TOL)
    assert stacked_vectors == 4 * tc.n_layers     # norm1/norm2 scale and bias
    # The difference is real: a norm scale starts at 1, so it is lr * wd.
    scale = "layers.0.norm1.scale"
    diff = (tnew["params"].get_parameter(scale).detach().numpy()
            - reference_leaf(jnew["params"], scale, tc))
    np.testing.assert_allclose(diff, opt.lr * opt.weight_decay, rtol=1e-2)


def test_adamw_alone_matches_reference():
    """Two AdamW steps on a tree of 1-d and n-d leaves, with clipping,
    weight decay and bias correction at step 2."""
    rng = np.random.default_rng(6)
    shapes = {"w": (6, 5), "b": (5,), "t": (2, 3, 4), "s": (1,)}
    params = {n: rng.standard_normal(s, dtype=np.float32) for n, s in shapes.items()}
    grads = [{n: 2 * rng.standard_normal(s, dtype=np.float32)
              for n, s in shapes.items()} for _ in range(2)]
    jopt, topt = JO.AdamWConfig(), TO.AdamWConfig()
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    js = JO.adamw_init(jp, jopt)
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    ts = TO.adamw_init(tp, topt)
    for g in grads:
        jp, js, jm = JO.adamw_update({n: jnp.asarray(v) for n, v in g.items()},
                                     js, jp, jopt)
        tp, ts, tm = TO.adamw_update({n: torch.from_numpy(v) for n, v in g.items()},
                                     ts, tp, topt)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["clip"]), float(jm["clip"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 2
    for n in shapes:
        for got, want in ((tp[n], jp[n]), (ts["m"][n], js["m"][n]),
                          (ts["v"][n], js["v"][n])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6, err_msg=n)


# --------------------------------------------------------------------------
# model under autograd, conversion, data, launcher
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["starcoder2-3b", "recurrentgemma-9b"])
def test_remat_gives_the_same_gradients(arch):
    """Checkpointed super-blocks (``full`` and ``save_attn``) and no
    checkpointing give the same gradients; recurrentgemma has a remainder."""
    base = dataclasses.replace(tiny_config(arch), dtype=torch.float32)
    if arch == "recurrentgemma-9b":
        base = dataclasses.replace(base, n_layers=5)
    toks = torch.from_numpy(_np_batch(7, base.vocab, B=2, S=12)["tokens"]).long()
    grads = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "save_attn")):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        model = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        model.requires_grad_(True)
        logits, _ = model(toks)
        loss = logits[..., :cfg.vocab].float().logsumexp(-1).mean()
        grads[(remat, policy)] = torch.autograd.grad(loss, list(model.parameters()))
    ref = grads.pop((False, "full"))
    for key, gs in grads.items():
        for g, r in zip(gs, ref):
            torch.testing.assert_close(g, r, atol=1e-6, rtol=1e-5, msg=str(key))


def test_serving_builds_no_graph():
    model = TT.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in model.parameters())
    logits, _ = model(_batch(8)["tokens"])
    assert logits.grad_fn is None


@pytest.mark.parametrize("arch", ["starcoder2-3b", "recurrentgemma-9b"])
def test_reference_path_finds_every_leaf(arch):
    jc = dataclasses.replace(jtiny(arch), dtype=jnp.float32, n_layers=5)
    tc = dataclasses.replace(tiny_config(arch), dtype=torch.float32, n_layers=5)
    tree = jax.device_get(JTS.train_state_init(jax.random.PRNGKey(1), jc,
                                               JO.AdamWConfig())["params"])
    sd = params_from_reference(tree, tc)
    assert sd.keys() == dict(TT.Transformer(tc, "cpu").named_parameters()).keys()
    for n, t in sd.items():
        np.testing.assert_array_equal(reference_leaf(tree, n, tc), t.numpy())
    assert reference_path("layers.3.mixer.wq", dataclasses.replace(
        tc, pattern=("attn",))) == (("blocks", "b0", "mixer", "wq"), 3)


def test_synthetic_batch_deterministic_with_next_token_labels():
    a, b = _batch(3, B=3, S=10), _batch(3, B=3, S=10)
    c = synthetic_batch(torch.Generator().manual_seed(3), CFG, 3, 10, "cpu")
    for k in ("tokens", "labels"):
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])
        assert a[k].shape == (3, 10) and a[k].dtype == torch.int64
    assert not torch.equal(a["tokens"], _batch(4, B=3, S=10)["tokens"])
    assert torch.equal(a["labels"], torch.roll(a["tokens"], -1, dims=1))
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < CFG.vocab
    with pytest.raises(NotImplementedError, match="not yet ported"):
        synthetic_batch(0, dataclasses.replace(CFG, frontend="audio"), 2, 4,
                        "cpu")


def test_launch_train_tiny_on_cpu(capsys):
    res = tlaunch.run(["--arch", ARCH, "--tiny", "--device", "cpu", "--steps",
                       "3", "--batch", "4", "--seq", "16"])
    assert len(res.losses) == len(res.step_ms) == 3
    assert all(np.isfinite(res.losses)) and res.peak_bytes is None
    assert int(res.state["step"]) == 3
    out = capsys.readouterr().out
    assert "tokens/s" in out and "step     3" in out


@pytest.mark.parametrize("flag", [["--ckpt-every", "2"], ["--fail-at", "1"],
                                  ["--mesh", "single"]])
def test_launch_train_refuses_unported_options(flag):
    # --mesh waits for the distribution slice; --ckpt-every and --fail-at
    # run since the checkpoint slice.
    argv = ["--arch", ARCH, "--tiny", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "8", *flag]
    if flag[0] == "--mesh":
        with pytest.raises(NotImplementedError, match="slice"):
            tlaunch.run(argv)
        return
    res = tlaunch.run(argv)
    if flag[0] == "--ckpt-every":
        assert res.ckpt_steps == [2] and sorted(res.ckpt.manifests) == [2]
        assert res.replayed == [] and len(res.losses) == 2
    else:       # a failure with no checkpoint restarts from step 0
        assert res.ckpt is None and res.replayed == [1]
        assert len(res.losses) == 3 and res.losses[0] == res.losses[1]


_TINY_RUN = ["--arch", ARCH, "--tiny", "--device", "cpu", "--batch", "4",
             "--seq", "16"]


@pytest.fixture(scope="module")
def uninterrupted():
    return tlaunch.run(_TINY_RUN + ["--steps", "5", "--ckpt-every", "2"])


@pytest.mark.parametrize("consistency", ["commit", "session", "posix", "mpiio"])
def test_launch_train_fail_at_resumes_to_the_uninterrupted_losses(
        uninterrupted, consistency, capsys):
    res = tlaunch.run(_TINY_RUN + ["--steps", "5", "--ckpt-every", "2",
                                   "--fail-at", "3", "--consistency",
                                   consistency])
    # Steps 1, 2, 3, then 3 again from the step-2 checkpoint, 4 and 5.
    assert res.ckpt_steps == [2, 4] and res.replayed == [3]
    assert len(res.losses) == len(res.step_ms) == 6
    assert len(res.save_ms) == 2 and len(res.restore_ms) == 1
    assert res.losses[:3] + res.losses[4:] == uninterrupted.losses
    assert res.losses[3] == res.losses[2]
    assert int(res.state["step"]) == 5
    want = dict(uninterrupted.state["params"].named_parameters())
    for n, p in res.state["params"].named_parameters():
        assert torch.equal(p, want[n]), n
    out = capsys.readouterr().out
    assert f"checkpoint saved ({consistency}" in out
    assert "elastic restart from checkpoint 2 on 3 hosts" in out


def test_launch_train_failure_before_first_checkpoint_restarts_from_zero(
        uninterrupted, capsys):
    res = tlaunch.run(_TINY_RUN + ["--steps", "5", "--ckpt-every", "4",
                                   "--fail-at", "2"])
    assert res.replayed == [1, 2] and res.ckpt_steps == [4]
    assert res.losses[2:] == uninterrupted.losses
    assert res.losses[:2] == uninterrupted.losses[:2]
    assert "before the first checkpoint; restart from step 0" in \
        capsys.readouterr().out


def test_launch_train_batches_depend_on_seed_and_step_alone():
    assert tlaunch.batch_seed(0, 3) == tlaunch.batch_seed(0, 3)
    seeds = {tlaunch.batch_seed(s, i) for s in range(3) for i in range(50)}
    assert len(seeds) == 150


@pytest.mark.parametrize("flag", [["--ckpt-hosts", "0"], ["--fail-at", "-1"]])
def test_launch_train_rejects_bad_checkpoint_options(flag):
    with pytest.raises(ValueError):
        tlaunch.run(_TINY_RUN + ["--steps", "2", *flag])


def test_launch_train_same_batch_memorizes():
    # The launcher's trained state goes on through the same train step on
    # one batch, as chip_smoke.py's main path does after the launcher.
    res = tlaunch.run(["--arch", ARCH, "--tiny", "--device", "cpu", "--steps",
                       "2", "--batch", "4", "--seq", "16"])
    step = make_train_step(res.cfg, TO.AdamWConfig(lr=3e-3))
    state, batch, losses = res.state, _batch(5), []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert int(state["step"]) == 8
    assert losses[-1] < losses[0] - 0.1, losses

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
import json
import os
import subprocess
import sys
import textwrap

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


def _both_states(arch, wd, seed=0, bf16_moments=False):
    """One reference train state, and the port's state loaded from it
    (``bf16_moments``: both keep the AdamW moments in bf16)."""
    jc = dataclasses.replace(jtiny(arch), dtype=jnp.float32)
    tc = dataclasses.replace(tiny_config(arch), dtype=torch.float32)
    if bf16_moments:
        jc = dataclasses.replace(jc, opt_state_dtype=jnp.bfloat16)
        tc = dataclasses.replace(tc, opt_state_dtype=torch.bfloat16)
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


def _one_step(arch, M, wd, batch_seed=5, bf16_moments=False):
    jc, tc, jopt, topt, jstate, tstate = _both_states(arch, wd,
                                                      bf16_moments=bf16_moments)
    batch = _np_batch(batch_seed, jc.vocab)
    before = _leaves(tstate["params"])
    jnew, jm = jax.jit(JTS.make_train_step(jc, jopt, num_microbatches=M))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = make_train_step(tc, topt, num_microbatches=M)(
        tstate, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    return tc, before, jax.device_get(jnew), jm, tnew, tm


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen3-32b",
                                  "falcon-mamba-7b", "recurrentgemma-9b",
                                  "qwen2-72b", "llama3-405b"])
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


def test_llama3_step_with_bf16_moments_matches_reference():
    """llama3-405b keeps its AdamW moments in bf16 (CONFIG.opt_state_dtype):
    one TINY step with bf16 moments on both sides.  The moments are held at
    the bf16 tolerance, 2e-2 (each side rounds its f32 update to bf16 once,
    so a moment may sit one bf16 ulp from the other's); the parameters,
    updated in f32 from those moments, at 1e-4."""
    tc, _, jnew, jm, tnew, tm = _one_step("llama3-405b", 1, wd=0.0,
                                          bf16_moments=True)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-5, rtol=1e-5)
    for n, p in tnew["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   reference_leaf(jnew["params"], n, tc),
                                   atol=1e-4, rtol=1e-4, err_msg=n)
        for mom in ("m", "v"):
            got = tnew["opt"][mom][n]
            assert got.dtype == torch.bfloat16, (mom, n)
            np.testing.assert_allclose(
                got.float().numpy(),
                np.asarray(reference_leaf(jnew["opt"][mom], n, tc), np.float32),
                atol=2e-2, rtol=2e-2, err_msg=f"{mom} {n}")


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
    # An audio arch's batch also holds its stub frames, from the same seed.
    audio = dataclasses.replace(CFG, frontend="audio")
    a = synthetic_batch(0, audio, 2, 4, "cpu")
    assert a["frames"].shape == (2, audio.enc_len, audio.d_model)
    assert torch.equal(a["frames"], synthetic_batch(0, audio, 2, 4, "cpu")["frames"])
    assert torch.equal(a["tokens"], _batch(0, B=2, S=4)["tokens"])


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
    # Every option runs since the sharded-checkpoint slice: --mesh trains
    # unsharded below 256 ranks, and with 256 (a fake group, in a process of
    # its own since the group is process-wide) a sharded state is trained
    # and checkpointed with --ckpt-every, its manifest an unsharded save's
    # (the bytes are held equal on 8 gloo ranks, test_torch_distributed.py).
    # --ckpt-every and --fail-at run since the checkpoint slice.
    argv = ["--arch", ARCH, "--tiny", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "8", *flag]
    if flag[0] == "--mesh":
        assert len(tlaunch.run(argv).losses) == 2
        # A fake group moves no data, so the values are meaningless; qwen3's
        # tensor-parallel rules index nothing by a gathered value.
        argv[1] = "qwen3-32b"
        code = textwrap.dedent(f"""
            import json
            from repro_torch.checkpoint.serialization import is_sharded
            from repro_torch.launch import mesh, train
            mesh.fake_world(256)
            res = train.run({argv + ["--ckpt-every", "2"]!r})
            print(json.dumps({{"steps": res.ckpt_steps, "sharded": is_sharded(res.state),
                              "manifest": res.ckpt.manifests[2]}}))
        """)
        env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__),
                                                       "..", "src"))
        r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                           text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        got = json.loads(r.stdout.strip().splitlines()[-1])
        plain = tlaunch.run(argv[:-2] + ["--ckpt-every", "2"])
        assert got["steps"] == [2] and got["sharded"]
        assert got["manifest"] == plain.ckpt.manifests[2]
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


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_launch_train_recurrent_tiny_on_cpu(arch):
    """The recurrent archs train through the launcher (their scans' plain
    versions on the CPU), and the trained state goes on through the same
    train step on one batch, where the loss falls."""
    res = tlaunch.run(["--arch", arch, "--tiny", "--device", "cpu", "--steps",
                       "2", "--batch", "4", "--seq", "16", "--microbatches", "1"])
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    step = make_train_step(res.cfg, TO.AdamWConfig(lr=3e-3))
    state, batch, losses = res.state, _batch(5, cfg=res.cfg), []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert int(state["step"]) == 8
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1, losses


def test_adamw_in_slices_equals_one_pass(monkeypatch):
    """adamw_update walks each leaf in slices of SLICE elements; the update
    is elementwise, so slices of 7 give the bits of one pass per leaf."""
    runs = []
    for size in (TO.SLICE, 7):
        monkeypatch.setattr(TO, "SLICE", size)
        opt = TO.AdamWConfig(lr=1e-2)
        state = _state(opt, seed=2)
        for seed in (3, 4):
            state, _ = make_train_step(CFG, opt)(state, _batch(seed))
        runs.append(state)
    (a, b) = runs
    for n, p in a["params"].named_parameters():
        assert torch.equal(p, dict(b["params"].named_parameters())[n]), n
        for mom in ("m", "v"):
            assert torch.equal(a["opt"][mom][n], b["opt"][mom][n]), (mom, n)


# --------------------------------------------------------------------------
# the fused AdamW kernel's wrapper (its card tests: tests/test_torch_cuda.py)
# --------------------------------------------------------------------------
def test_adamw_on_cpu_takes_the_slice_loop_and_builds_nothing(monkeypatch):
    """CPU leaves take update_in_slices: the kernel's counters stay, no build
    is attempted, and each leaf gets the slice loop's bits."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import adamw as AK

    def no_build(source):
        raise AssertionError(f"a build of {source} was attempted")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    seen = []
    plain = TO.update_in_slices

    def spy(p, *args, **kw):
        seen.append(p.numel())
        plain(p, *args, **kw)

    monkeypatch.setattr(TO, "update_in_slices", spy)
    launches, elements = AK.LAUNCHES, AK.ELEMENTS
    opt = TO.AdamWConfig(lr=1e-2)
    state = _state(opt, seed=5)
    state, _ = make_train_step(CFG, opt)(state, _batch(6))
    assert (AK.LAUNCHES, AK.ELEMENTS) == (launches, elements)
    params = list(state["params"].parameters())
    assert seen == [p.numel() for p in params]


def _meta_leaf(shape, p_dtype, g_dtype, s_dtype):
    meta = dict(device="meta")
    scalars = [torch.empty((), dtype=torch.float32, **meta) for _ in range(3)]
    return (torch.empty(shape, dtype=p_dtype, **meta),
            torch.empty(shape, dtype=g_dtype, **meta),
            torch.empty(shape, dtype=s_dtype, **meta),
            torch.empty(shape, dtype=s_dtype, **meta), *scalars)


HYPER = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtypes,per_param", [
    ((BF16, BF16, F32), 22), ((F32, F32, F32), 28), ((BF16, F32, F32), 24),
    ((BF16, BF16, BF16), 14)], ids=["bf16-bf16-f32", "f32-f32-f32",
                                   "bf16-f32-f32", "bf16-bf16-bf16"])
@pytest.mark.parametrize("decay", [False, True], ids=["no-decay", "decay"])
def test_adamw_kernel_on_meta_records_its_bytes_and_launches_nothing(
        dtypes, per_param, decay):
    """On meta tensors (the dry run) the wrapper launches nothing and
    records one read of p, g, m, v and one write of p, m, v: 22 B a
    parameter for bf16 p and g with f32 moments.  Its elementwise arithmetic
    counts no FLOPs, as PyTorch's elementwise ops count none."""
    from repro_torch.kernels import accounting
    from repro_torch.kernels import adamw as AK
    launches, elements = AK.LAUNCHES, AK.ELEMENTS
    accounting.reset()
    AK.adamw_cuda(*_meta_leaf((64, 48), *dtypes), **HYPER, decay=decay)
    AK.adamw_cuda(*_meta_leaf((0, 48), *dtypes), **HYPER, decay=decay)
    rec = accounting.snapshot()["adamw"]
    accounting.reset()
    n = 64 * 48
    assert rec["bytes"] == per_param * n
    assert rec["launches"] == 1                 # the empty leaf is skipped
    assert rec["flops"] == rec["dense_flops"] == 0
    assert rec["special"] == n
    assert (AK.LAUNCHES, AK.ELEMENTS) == (launches, elements)


def test_adamw_update_on_meta_records_one_kernel_per_leaf():
    from repro_torch.kernels import accounting
    shapes = {"w": (6, 5), "b": (5,), "t": (2, 3, 4)}
    params = {n: torch.empty(s, dtype=BF16, device="meta") for n, s in shapes.items()}
    grads = {n: torch.empty_like(p) for n, p in params.items()}
    state = TO.adamw_init(params, TO.AdamWConfig())
    accounting.reset()
    TO.adamw_update(grads, state, params, TO.AdamWConfig())
    rec = accounting.snapshot()["adamw"]
    accounting.reset()
    assert rec["launches"] == 3
    assert rec["bytes"] == 22 * (30 + 5 + 24)


def test_adamw_kernel_wrapper_refuses_what_it_does_not_take():
    from repro_torch.kernels import adamw as AK
    p, g, m, v, clip, bc1, bc2 = _meta_leaf((8, 4), BF16, BF16, F32)
    cpu = [torch.zeros_like(t, device="cpu") for t in (p, g, m, v, clip, bc1, bc2)]
    with pytest.raises(ValueError, match="CUDA"):
        AK.adamw_cuda(*cpu, **HYPER, decay=True)
    m_t = torch.empty((4, 8), dtype=F32, device="meta").t()
    with pytest.raises(ValueError, match="m is not contiguous"):
        AK.adamw_cuda(p, g, m_t, v, clip, bc1, bc2, **HYPER, decay=True)
    with pytest.raises(TypeError, match="float16"):
        AK.adamw_cuda(p.to(torch.float16), g, m, v, clip, bc1, bc2, **HYPER,
                      decay=True)
    with pytest.raises(TypeError, match="m torch.float32, v torch.bfloat16"):
        AK.adamw_cuda(p, g, m, v.to(BF16), clip, bc1, bc2, **HYPER, decay=True)
    with pytest.raises(TypeError, match="must be one of"):     # f32 p, bf16 g
        AK.adamw_cuda(p.to(F32), g, m, v, clip, bc1, bc2, **HYPER, decay=True)
    with pytest.raises(TypeError, match="0-d float32"):
        AK.adamw_cuda(p, g, m, v, clip.reshape(1), bc1, bc2, **HYPER, decay=True)
    with pytest.raises(ValueError, match="shapes"):
        AK.adamw_cuda(p, g[:4], m, v, clip, bc1, bc2, **HYPER, decay=True)

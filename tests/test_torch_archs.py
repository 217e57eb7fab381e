"""Every one of the reference's ten archs in the port: the registry, the
model's parameter tree at full width (built on the meta device, against the
reference's abstract ``init_params``), and the launchers on the CPU for the
four archs of the MoE / encoder-decoder / vision slice.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs.registry import (ARCHS, NOT_YET_PORTED,  # noqa: E402
                                          get_config, tiny_config)
from repro_torch.convert import reference_layout, reference_path  # noqa: E402
from repro_torch.launch import profile_serve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.transformer import Transformer, init_params  # noqa: E402

NEW = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "whisper-small",
       "paligemma-3b"]


def test_registry_resolves_all_ten_archs():
    assert sorted(ARCHS) == sorted(JARCHS) and len(ARCHS) == 10
    assert NOT_YET_PORTED == ()
    for arch in ARCHS:
        assert get_config(arch).name == arch
        assert tiny_config(arch).vocab == 128
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_full_width_model_has_the_reference_tree(arch):
    """At full width, on the meta device: every port parameter maps to a
    reference leaf of its shape (a stacked leaf's slice) and dtype, and the
    reference's tree, rebuilt from the port's parameters
    (``reference_layout``), has the reference's leaves."""
    cfg = get_config(arch)
    model = Transformer(cfg, device="meta")
    ref = jax.eval_shape(lambda k: JT.init_params(k, jget(arch)),
                         jax.random.PRNGKey(0))
    ref_leaves = dict(_leaves(ref))
    params = dict(model.named_parameters())
    for name, p in params.items():
        path, index = reference_path(name, cfg)
        want = ref_leaves[path]
        shape = want.shape if index is None else want.shape[1:]
        assert tuple(p.shape) == shape, name
        assert str(p.dtype).removeprefix("torch.") == np.dtype(want.dtype).name, name
    layout = dict(_leaves(reference_layout(params, cfg)))
    assert layout.keys() == ref_leaves.keys()
    for path, leaf in layout.items():
        want = ref_leaves[path]
        if isinstance(leaf, list):       # a stack: one port tensor per index
            assert len(leaf) == want.shape[0], path
            assert all(t is not None for t in leaf), path
        else:
            assert tuple(leaf.shape) == want.shape, path
    total = sum(p.numel() for p in params.values())
    assert total == sum(math.prod(v.shape) for v in ref_leaves.values())


@pytest.mark.parametrize("arch", NEW)
def test_launch_serve_tiny_on_cpu(arch, capsys):
    run = tserve.run(["--arch", arch, "--tiny", "--batch", "2", "--prompt-len",
                      "6", "--steps", "4", "--device", "cpu"])
    assert tuple(run.tokens.shape) == (2, 4)
    assert all(bool(torch.isfinite(lg).all()) for lg in run.logits)
    out = capsys.readouterr().out
    assert "prefill:" in out and "ms/step" in out


@pytest.mark.parametrize("arch", NEW)
def test_launch_train_tiny_on_cpu(arch, capsys):
    res = tlaunch.run(["--arch", arch, "--tiny", "--device", "cpu", "--steps",
                       "3", "--batch", "4", "--seq", "16"])
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert int(res.state["step"]) == 3
    assert "tokens/s" in capsys.readouterr().out


def test_launch_train_vision_with_microbatches():
    """paligemma TINY with 2 microbatches: the loss is the CE of the text
    positions only, near log(vocab) for uniform tokens."""
    res = tlaunch.run(["--arch", "paligemma-3b", "--tiny", "--device", "cpu",
                       "--steps", "2", "--batch", "4", "--seq", "16",
                       "--microbatches", "2"])
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert abs(res.losses[0] - math.log(128)) < 1.0


def test_profile_serve_tiny_vision_on_cpu(capsys):
    rc = profile_serve.main(["--arch", "paligemma-3b", "--tiny", "--batch", "2",
                             "--prompt-len", "6", "--steps", "3", "--device",
                             "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "== prefill: wall" in out and "== decode (2 steps): wall" in out


def test_serve_decodes_after_the_patch_prefix():
    """launch.serve on a vision arch: the cache is patches + prompt + steps
    long and greedy tokens equal decoding by the full forward."""
    args = tserve.parse_args(["--arch", "paligemma-3b", "--tiny", "--batch", "2",
                              "--prompt-len", "5", "--steps", "4", "--device",
                              "cpu"])
    model, prompt, extras = tserve.setup(args)
    assert extras["patches"].shape == (2, model.cfg.vision_patches,
                                       model.cfg.d_model)
    run = tserve.serve_batch(model, prompt, 4, extras)
    seq = prompt
    with torch.inference_mode():
        for i in range(4):
            logits, _ = model(seq, **extras)
            tok = logits[:, -1, :model.cfg.vocab].argmax(-1)
            assert torch.equal(tok, run.tokens[:, i]), i
            seq = torch.cat([seq, tok[:, None]], dim=1)


def test_moe_a2a_config_takes_sort_scatter():
    """granite's ``moe_impl="a2a"`` gives the same logits as
    ``sort_scatter``: the port has no mesh (the reference's fallback)."""
    cfg = dataclasses.replace(tiny_config("granite-moe-1b-a400m"),
                              dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    outs = []
    for impl in ("a2a", "sort_scatter"):
        model = init_params(dataclasses.replace(cfg, moe_impl=impl),
                            torch.Generator().manual_seed(1), "cpu")
        with torch.inference_mode():
            outs.append(model(toks))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_profile_train_tiny_on_cpu(capsys):
    from repro_torch.launch import profile_train
    rc = profile_train.main(["--arch", "granite-moe-1b-a400m", "--tiny",
                             "--batch", "2", "--seq", "8", "--steps", "1",
                             "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "== train step: wall" in out and "loss " in out
    for phase in ("forward", "backward", "optimizer"):
        assert f"span repro_torch.train.{phase} (1x, host)" in out, phase
    assert "span repro_torch.moe.dispatch" in out

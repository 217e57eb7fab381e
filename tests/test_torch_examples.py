"""The port's example twins (``repro_torch.examples``) against the
reference's examples, on the CPU.

Each pair runs at the same flags (``train_checkpoint`` at its quick flags
``--steps 12 --d-model 256 --layers 4``) and must print the same lines.
The port's twins draw their initial weights from torch's generator, so here
both start from the reference's parameters, converted
(``repro_torch.convert``), and the quickstart from its batch.  Both
optimizers run with ``weight_decay=0``: at the default the reference also
decays the per-layer norm scales and biases of its stacked tree, which the
port does not (pinned by ``tests/test_torch_train.py``).  Printed losses may
differ by one unit in their last printed place (1e-4), the rounding of f32
sums that agree to ``tests/test_torch_train.py``'s tolerances; every other
printed number, the DES's checkpoint bandwidth included, is equal.
"""

import argparse
import dataclasses
import functools
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import tiny_config as jtiny  # noqa: E402
from repro.data.pipeline import synthetic_batch as jbatch  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference, to_tensor)
from repro_torch.examples import dl_ingest, quickstart  # noqa: E402
from repro_torch.examples import train_checkpoint  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS = re.compile(r"loss (\d+\.\d{4})")


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(mod, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py", *argv])
    mod.main()
    return capsys.readouterr().out


def _port_state(jstate, tc):
    """The port's train state loaded from a reference train state."""
    host = jax.device_get(jstate)
    model = TT.Transformer(tc, device="cpu")
    model.load_state_dict(params_from_reference(host["params"], tc))
    return {"params": model.requires_grad_(True),
            "opt": opt_state_from_reference(host["opt"], tc),
            "step": to_tensor(np.asarray(host["step"]))}


def _same_lines(got, want):
    """Equal outputs, but for each printed loss one unit in its last place
    and the wall-clock seconds per step."""
    strip = functools.partial(re.sub, r"\(\d+\.\d+s/step\)", "(s/step)")
    got, want = strip(got), strip(want)
    gl, wl = LOSS.findall(got), LOSS.findall(want)
    assert len(gl) == len(wl) > 0
    for g, w in zip(gl, wl):
        assert abs(float(g) - float(w)) <= 1.5e-4, (g, w)
    assert LOSS.sub("loss L", got) == LOSS.sub("loss L", want)


def test_dl_ingest_prints_the_reference_example(monkeypatch, capsys):
    argv = ["--hosts", "4", "--samples-per-host", "32"]
    want = _run_reference(_reference_example("dl_ingest"), argv, monkeypatch,
                          capsys)
    dl_ingest.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert "query RPCs" in got


def test_train_checkpoint_prints_the_reference_example(monkeypatch, capsys):
    argv = ["--steps", "12", "--d-model", "256", "--layers", "4"]
    ref = _reference_example("train_checkpoint")
    monkeypatch.setattr(ref, "AdamWConfig",
                        functools.partial(JO.AdamWConfig, weight_decay=0.0))
    monkeypatch.setattr(train_checkpoint, "AdamWConfig",
                        functools.partial(TO.AdamWConfig, weight_decay=0.0))
    jcfg = ref.build_cfg(argparse.Namespace(d_model=256, layers=4))
    jstate = JTS.train_state_init(jax.random.PRNGKey(1), jcfg,
                                  JO.AdamWConfig(lr=1e-3, weight_decay=0.0))

    def init(gen, cfg, opt, device):
        assert dataclasses.asdict(cfg) == {**dataclasses.asdict(jcfg),
                                           "dtype": torch.float32,
                                           "opt_state_dtype": torch.float32}
        return _port_state(jstate, cfg)

    monkeypatch.setattr(train_checkpoint, "train_state_init", init)
    want = _run_reference(ref, argv, monkeypatch, capsys)
    run = train_checkpoint.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    _same_lines(got, want)
    assert "mean modeled checkpoint bandwidth" in got
    assert len(run.losses) == 12 and run.restored_step == run.fail_step == 6
    assert run.ckpt_steps == [6, 12] and run.ckpt_bandwidth > 0


def test_quickstart_prints_the_reference_example(monkeypatch, capsys):
    ref = _reference_example("quickstart")
    monkeypatch.setattr(ref, "opt_for", lambda cfg: JO.AdamWConfig(
        state_dtype=cfg.opt_state_dtype, weight_decay=0.0))
    monkeypatch.setattr(quickstart, "AdamWConfig",
                        functools.partial(TO.AdamWConfig, weight_decay=0.0))
    jcfg = dataclasses.replace(jtiny("qwen3-32b"), dtype=jnp.float32)
    jstate = JTS.train_state_init(jax.random.PRNGKey(0), jcfg,
                                  ref.opt_for(jcfg))
    jb = jbatch(jax.random.PRNGKey(1), jcfg, batch=8, seq=32)
    monkeypatch.setattr(quickstart, "train_state_init",
                        lambda gen, cfg, opt, device: _port_state(jstate, cfg))
    monkeypatch.setattr(quickstart, "synthetic_batch",
                        lambda seed, cfg, batch, seq, device: {
                            k: torch.from_numpy(np.array(v)).long()
                            for k, v in jb.items()})
    want = _run_reference(ref, [], monkeypatch, capsys)
    quickstart.main(["--device", "cpu"])
    got = capsys.readouterr().out
    _same_lines(got, want)
    assert "checkpoint roundtrip exact: True" in got


@pytest.mark.parametrize("main", [dl_ingest.main, quickstart.main,
                                  train_checkpoint.main],
                         ids=["dl_ingest", "quickstart", "train_checkpoint"])
def test_examples_refuse_a_missing_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([])

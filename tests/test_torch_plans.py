"""Per-device work of the port's sharded step against the reference's GSPMD
plan of the same step.

For each of the ten archs (TINY configs, f32) and each of a train and a
prefill cell, rank 0 of the port's step on a fake (data=2, model=4) group
(``repro_torch.launch.dryrun.run_cell`` with ``mesh.fake_world(8)``, as
``tests/test_torch_dryrun.py`` runs its small cells) may do at most 1.15x
the dot FLOPs per device of the reference's step compiled on a (2, 4) mesh
of 8 forced host devices with ``Auto`` axes (``parse_hlo_costs`` of the
compiled module, attention at its dense count on both sides).  A product
that DTensor plans op by op, or a module run whole on every rank, repeats
work over a mesh axis and shows here as a multiple of the reference's
count.  Both sides run in subprocesses of their own, at once: the fake
group and the forced devices are process-wide.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("jax")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
ARCHS = ("whisper-small", "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
         "recurrentgemma-9b", "qwen3-32b", "llama3-405b", "qwen2-72b",
         "starcoder2-3b", "paligemma-3b", "falcon-mamba-7b")
# (name, seq_len, global batch, mode)
CELLS = (("train", 64, 8, "train"), ("prefill", 64, 8, "prefill"))
LIMIT = 1.15

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import jax, jax.numpy as jnp
    from repro.configs.registry import tiny_config
    from repro.launch import hlostats, mesh as M
    from repro.launch.dryrun import input_specs
    from repro.models.config import ShapeCell
    from repro.models.sharding import active_rules
    from repro.serve.decode import make_prefill
    from repro.train.train_step import make_train_step

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch in %(archs)r:
        cfg = dataclasses.replace(tiny_config(arch), dtype=jnp.float32)
        rules = M.arch_rules(cfg, False)
        for name, T, B, mode in %(cells)r:
            cell = ShapeCell(name, T, B, mode)
            with mesh, active_rules(rules, mesh):
                (a, b), _ = input_specs(cfg, cell)
                if mode == "train":
                    ss = M.state_shardings(cfg, mesh, rules)
                    step = make_train_step(cfg, M.opt_for(cfg),
                                           num_microbatches=cfg.microbatches)
                    fn = jax.jit(step, in_shardings=(ss, M.batch_shardings(
                        cfg, cell, mesh, rules)), out_shardings=(ss, None))
                else:
                    pf = make_prefill(cfg, max_len=T)
                    bs = M.batch_shardings(cfg, cell, mesh, rules)
                    fn = jax.jit(lambda p, bt: pf(p, bt["tokens"], **{
                        k: v for k, v in bt.items() if k != "tokens"}),
                        in_shardings=(M.params_shardings(cfg, mesh, rules),
                                      {k: bs[k] for k in b}))
                text = fn.lower(a, b).compile().as_text()
            out[arch + "/" + name] = hlostats.parse_hlo_costs(text)["flops"]
    print(json.dumps(out))
""")

PORT = textwrap.dedent("""
    import dataclasses, json, torch
    from repro_torch.configs.registry import tiny_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models.config import ShapeCell
    ms = D.MeshShape(("data", "model"), (2, 4))
    out = {}
    for arch in %(archs)r:
        cfg = dataclasses.replace(tiny_config(arch), dtype=torch.float32)
        for name, T, B, mode in %(cells)r:
            rec = D.run_cell(arch, name, "single", verbose=False, cfg=cfg,
                             mesh_shape=ms, cell=ShapeCell(name, T, B, mode))
            out[arch + "/" + name] = {"flops": rec["dense_flops_per_device"],
                                      "top": sorted(rec["by_op"].items(),
                                                    key=lambda kv: -kv[1]["dense_flops"])[:4]}
    print(json.dumps(out))
""")


def _start(code: str, archs) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code % {"archs": archs, "cells": CELLS}],
                            env=ENV, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def flops():
    """{arch/cell: (the port's rank-0 dense FLOPs and its largest ops, the
    reference's per-device FLOPs)}; each side in two subprocesses of half
    the archs, all four at once."""
    halves = (ARCHS[:5], ARCHS[5:])
    procs = [_start(code, archs) for code in (REFERENCE, PORT) for archs in halves]
    try:
        want, got = {}, {}
        for i, proc in enumerate(procs):
            (want if i < 2 else got).update(_result(proc))
    finally:
        for proc in procs:
            proc.kill()
    return {k: (got[k], want[k]) for k in want}


@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_flops_within_the_reference_plan(flops, arch, cell):
    got, want = flops[f"{arch}/{cell}"]
    assert got["flops"] <= LIMIT * want, (
        f"{arch} {cell}: {got['flops']:.4g} dot FLOPs on rank 0, "
        f"{got['flops'] / want:.3f}x the reference's {want:.4g}; largest: "
        + ", ".join(f"{k} {v['dense_flops']:.3g}" for k, v in got["top"]))

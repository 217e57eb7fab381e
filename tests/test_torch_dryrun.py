"""``repro_torch.launch.dryrun`` against ``repro.launch.dryrun``.

* ``input_specs`` gives what ``tests/test_launch_specs.py`` asks of the
  reference's, on ``device="meta"``.
* ``--list`` prints the reference's list.
* The per-device state, batch and cache bytes of every arch x live cell x
  mesh equal the reference's ``_sharded_bytes`` (the reference in a jax
  subprocess with 512 forced host devices, building shardings only; the
  port's per-layer leaves resolve to the same bytes as the reference's
  stacked ones, so the totals are compared whole).
* qwen3 TINY and recurrentgemma TINY cells run end to end on a fake (2, 4)
  mesh in a subprocess (the fake group is process-wide), with the decode
  step's collectives and every cell's kernel launches counted by hand.
* One rank's dot FLOPs of qwen3 TINY prefill and train, attention at its
  dense count, equal the reference's ``parse_hlo_costs`` of the compiled
  step within 2%.
* ``long_500k`` on a full-attention arch is skipped with the reference's
  reason, and a failing cell is written as ``status: error`` with its
  traceback, the run exiting 1.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs.registry import tiny_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.models.config import ShapeCell

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
CFG = dataclasses.replace(tiny_config("qwen3-32b"), dtype=torch.float32)


def _run(code: str, timeout: int = 600) -> dict:
    r = subprocess.run([sys.executable, "-c", code], env=ENV, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _meta_leaves(tree):
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _meta_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _meta_leaves(v)]
    return [tree]


def test_input_specs_train():
    cell = ShapeCell("t", 32, 8, "train")
    (state, batch), kw = D.input_specs(CFG, cell)
    assert kw == {}
    assert batch["tokens"].shape == (8, 32)
    assert batch["labels"].dtype == torch.int32
    assert set(state) == {"params", "opt", "step"}
    # no allocation happened: everything is on the meta device
    assert all(t.device.type == "meta" for t in _meta_leaves(state) + _meta_leaves(batch))


def test_input_specs_prefill_includes_modality():
    wcfg = dataclasses.replace(tiny_config("whisper-small"), dtype=torch.float32)
    (model, batch), kw = D.input_specs(wcfg, ShapeCell("p", 32, 4, "prefill"))
    assert batch["frames"].shape == (4, wcfg.enc_len, wcfg.d_model)
    assert all(t.device.type == "meta" for t in _meta_leaves(model))


def test_input_specs_decode_cache_shapes():
    (model, cache, tok, idx), kw = D.input_specs(CFG, ShapeCell("d", 64, 4, "decode"))
    assert tok.shape == (4, 1)
    # The port's decode position is a Python int (the reference's is a
    # 0-d int32): the cache's last slot.
    assert isinstance(idx, int) and idx == 63
    leaves = _meta_leaves(cache)
    assert all(t.device.type == "meta" for t in leaves)
    # attention KV caches carry the cell's max length
    assert any(t.dim() == 4 and t.shape[1] == 64 for t in leaves)


def test_abstract_state_matches_init_shapes():
    from repro_torch.train.train_step import train_state_init
    (state, _), _ = D.input_specs(CFG, ShapeCell("t", 32, 8, "train"))
    real = train_state_init(torch.Generator().manual_seed(0), CFG, M.opt_for(CFG),
                            "cpu")
    for a, r in zip(_meta_leaves(state), _meta_leaves(real)):
        assert a.shape == r.shape and a.dtype == r.dtype


def test_list_equals_the_reference(capsys):
    r = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--list"],
                       env=ENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert D.main(["--list"]) == 0
    assert capsys.readouterr().out == r.stdout


REF_BYTES = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json
    from repro.configs.registry import ARCHS
    from repro.launch import mesh as M
    from repro.launch.dryrun import _sharded_bytes
    from repro.models.config import shapes_for
    out = {}
    for multi in (False, True):
        mesh = M.make_production_mesh(multi_pod=multi)
        n = mesh.devices.size
        for arch, cfg in ARCHS.items():
            rules = M.arch_rules(cfg, multi)
            ps = _sharded_bytes(M.abstract_params(cfg),
                                M.params_shardings(cfg, mesh, rules), n)
            ss = _sharded_bytes(M.abstract_state(cfg),
                                M.state_shardings(cfg, mesh, rules), n)
            for cell in shapes_for(cfg):
                key = f"{arch}/{cell.name}/{'multi' if multi else 'single'}"
                if cell.mode == "train":
                    out[key] = {"state_bytes_per_device": ss,
                                "batch_bytes_per_device": _sharded_bytes(
                                    M.batch_abstract(cfg, cell),
                                    M.batch_shardings(cfg, cell, mesh, rules), n)}
                else:
                    out[key] = {"state_bytes_per_device": ps,
                                "cache_bytes_per_device": _sharded_bytes(
                                    M.cache_abstract(cfg, cell),
                                    M.cache_shardings(cfg, cell, mesh, rules), n)}
    print(json.dumps(out))
""")


def test_per_device_bytes_equal_the_reference_in_every_cell():
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.config import shapes_for
    want = _run(REF_BYTES)
    got = {}
    for multi in (False, True):
        for arch, cfg in ARCHS.items():
            rules = M.arch_rules(cfg, multi)
            for cell in shapes_for(cfg):
                key = f"{arch}/{cell.name}/{'multi' if multi else 'single'}"
                got[key] = D.cell_bytes(cfg, cell, D.production_shape(multi), rules)
    assert len(got) == 64          # 32 live cells x 2 meshes
    assert got == want


FAKE_CELLS = textwrap.dedent("""
    import json
    from repro_torch.configs.registry import tiny_config
    from repro_torch.launch import dryrun as D
    ms = D.MeshShape(("data", "model"), (2, 4))
    out = {}
    for arch in ("qwen3-32b", "recurrentgemma-9b"):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            out[arch + "/" + shape] = D.run_cell(arch, shape, "single",
                                                 cfg=tiny_config(arch),
                                                 mesh_shape=ms, verbose=False)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def tiny_cells():
    return _run(FAKE_CELLS)


def test_tiny_cells_run_on_a_fake_mesh(tiny_cells):
    for key, rec in tiny_cells.items():
        assert rec["status"] == "ok", key
        assert rec["devices"] == 8 and rec["mesh_shape"] == [2, 4]
        assert rec["flops_per_device"] > 0 and rec["op_bytes_per_device"] > 0
        assert rec["fits_80gb"]
    assert tiny_cells["qwen3-32b/train_4k"]["saved_bytes_per_device"] > 0


def test_tiny_decode_collectives_by_hand(tiny_cells):
    """On (data=2, model=4): the vocab-sharded embedding's partial sum is
    reduce-scattered and the batch layout gathered (1 RS + 1 AG); an
    attention layer projects its 2 KV heads, which the model axis does not
    divide, on head_dim slices and gathers them (2 AG), gathers the query's
    heads over its sequence-sharded cache (1 AG) and combines max, sum and
    p.v over the sequence shards (3 AR), then reduces the attention and FFN
    outputs (2 AR); an RG-LRU layer gathers the conv output's channel
    shards once for its two gate products (1 AG) and reduces its and the
    FFN's outputs (2 AR); the greedy argmax gathers the vocab shards (1 AG)."""
    qwen = tiny_cells["qwen3-32b/decode_32k"]["collectives"]
    n = tiny_config("qwen3-32b").n_layers                    # 2 attention layers
    assert qwen["count_by_kind"] == {"reduce-scatter": 1, "all-gather": 2 + 3 * n,
                                     "all-reduce": 5 * n}
    rg = tiny_cells["recurrentgemma-9b/decode_32k"]["collectives"]
    n_rg, n_local = 4, 1                                     # of 5 layers
    assert rg["count_by_kind"] == {"reduce-scatter": 1,
                                   "all-gather": 2 + n_rg + 3 * n_local,
                                   "all-reduce": 2 * n_rg + 5 * n_local}
    for c in (qwen, rg):
        assert c["count"] == sum(c["count_by_kind"].values())


def test_tiny_kernel_launches_by_hand(tiny_cells):
    """A checkpointed super-block runs its forward kernels twice a train
    step (qwen3 TINY: 2 super-blocks of one attention layer; recurrentgemma
    TINY: one super-block (rglru, rglru, local) and two rglru remainder
    layers, not checkpointed); a decode step runs only the norm kernel (its
    other one-token functions are plain torch).  A train step's AdamW runs
    its kernel once per parameter leaf (qwen3 TINY: 25 leaves,
    recurrentgemma TINY: 64).

    Norms: a qwen3 layer has 4 (before attention and FFN, and qk-norm's on
    q and k), a recurrentgemma layer 2 (no qk-norm), and the final norm 1.
    qwen3: 2 x 4 + 1 = 9 a forward (prefill, decode step), 2 x 2 x 4 + 1 =
    17 in a train step with the recompute, 9 backward.  recurrentgemma:
    5 x 2 + 1 = 11 a forward; a train step 3 x 2 x 2 (the super-block's
    recompute) + 2 x 2 + 1 = 17, 11 backward."""
    launches = {k: {n: v["launches"] for n, v in r["kernels"].items()}
                for k, r in tiny_cells.items()}
    assert launches["qwen3-32b/train_4k"] == {"flash_attention": 4,
                                              "flash_attention_bwd": 2,
                                              "norm": 17, "norm_bwd": 9,
                                              "adamw": 25}
    assert launches["qwen3-32b/prefill_32k"] == {"flash_attention": 2, "norm": 9}
    assert launches["recurrentgemma-9b/train_4k"] == {
        "rglru_scan": 6, "rglru_scan_bwd": 4, "flash_attention": 2,
        "flash_attention_bwd": 1, "norm": 17, "norm_bwd": 11, "adamw": 64}
    assert launches["recurrentgemma-9b/prefill_32k"] == {"rglru_scan": 4,
                                                         "flash_attention": 1,
                                                         "norm": 11}
    assert launches["qwen3-32b/decode_32k"] == {"norm": 9}
    assert launches["recurrentgemma-9b/decode_32k"] == {"norm": 11}


REF_FLOPS = textwrap.dedent("""
    import dataclasses, json
    import jax, jax.numpy as jnp
    from repro.configs.registry import tiny_config
    from repro.launch import hlostats, mesh as M
    from repro.launch.dryrun import input_specs
    from repro.models.config import ShapeCell
    from repro.serve.decode import make_prefill
    from repro.train.train_step import make_train_step
    cfg = dataclasses.replace(tiny_config("qwen3-32b"), dtype=jnp.float32)
    (state, batch), _ = input_specs(cfg, ShapeCell("t", 32, 8, "train"))
    step = make_train_step(cfg, M.opt_for(cfg), num_microbatches=cfg.microbatches)
    text = jax.jit(step).lower(state, batch).compile().as_text()
    out = {"train": hlostats.parse_hlo_costs(text)["flops"]}
    (params, batch), _ = input_specs(cfg, ShapeCell("p", 32, 4, "prefill"))
    pf = make_prefill(cfg, max_len=32)
    text = jax.jit(lambda p, b: pf(p, b["tokens"])).lower(params, batch).compile().as_text()
    out["prefill"] = hlostats.parse_hlo_costs(text)["flops"]
    print(json.dumps(out))
""")


def test_single_rank_dot_flops_equal_the_reference():
    from repro_torch.launch import hlostats as H
    from repro_torch.serve.decode import make_prefill
    from repro_torch.train.train_step import make_train_step
    want = _run(REF_FLOPS)
    (state, batch), _ = D.input_specs(CFG, ShapeCell("t", 32, 8, "train"))
    with H.StepCounter() as train:
        make_train_step(CFG, M.opt_for(CFG), num_microbatches=CFG.microbatches)(
            state, batch)
    (model, batch), _ = D.input_specs(CFG, ShapeCell("p", 32, 4, "prefill"))
    with H.StepCounter() as prefill, torch.no_grad():
        make_prefill(model, 32)(batch["tokens"])
    for name, c in (("train", train), ("prefill", prefill)):
        got = c.totals()["dense_flops"]
        assert abs(got - want[name]) <= 0.02 * want[name], (name, got, want[name])
        # the kernel's own count skips masked pairs: less than dense
        assert c.totals()["flops"] < got


def test_full_attention_long_500k_is_skipped():
    want = _run("import json\nfrom repro.launch.dryrun import run_cell\n"
                "print(json.dumps(run_cell('qwen3-32b', 'long_500k', 'single')))")
    got = D.run_cell("qwen3-32b", "long_500k", "single")
    assert got == want and got["status"] == "skipped"


def test_failing_cell_is_an_error_artifact(tmp_path, monkeypatch, capsys):
    def fail(*a, **k):
        raise RuntimeError("no plan")

    monkeypatch.setattr(D, "ARTIFACT_DIR", str(tmp_path))
    monkeypatch.setattr(D, "run_cell", fail)
    assert D.main(["--arch", "qwen3-32b", "--shape", "train_4k"]) == 1
    rec = json.loads((tmp_path / "qwen3-32b__train_4k__single.json").read_text())
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: no plan"
    assert "Traceback" in rec["traceback"]

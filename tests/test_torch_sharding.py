"""The port's logical-axis sharding (``repro_torch.models.sharding``), its
spec functions and ``repro_torch.launch.mesh`` against the JAX reference,
with no process group.

The reference's ``resolve_spec`` reads only ``mesh.axis_names`` and
``mesh.devices.shape``, the port's only ``mesh.mesh_dim_names`` and
``mesh.shape``, so one stand-in object serves both as a mesh.  Rules and
resolved specs must be equal for every policy, with and without the pod
axis and fsdp, over shapes that do and do not divide; the specs of every
parameter and cache leaf of all ten archs (full and tiny configs) equal the
reference's leaf by leaf, with the stacked axis dropped where
``convert.reference_path`` maps a port layer into a stacked leaf.
"""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.configs.registry import tiny_config as jtiny  # noqa: E402
from repro.models import sharding as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro_torch.configs.registry import get_config, tiny_config  # noqa: E402
from repro_torch.convert import reference_path  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import sharding as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import ShapeCell  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402


def _mesh(shape, names):
    """A stand-in mesh for both packages."""
    return SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=object),
                           mesh_dim_names=names, shape=shape)


MESH = _mesh((16, 16), ("data", "model"))
MESH3 = _mesh((2, 16, 16), ("pod", "data", "model"))
SMALL = _mesh((2, 4), ("data", "model"))
POLICY = list(itertools.product(("tp", "fsdp", "dp"), (False, True), (False, True)))
ARCHS = sorted(JARCHS)


@pytest.mark.parametrize("policy,multi_pod,fsdp", POLICY)
def test_rules_for_equal_reference(policy, multi_pod, fsdp):
    assert TS.rules_for(policy, multi_pod, fsdp) == JS.rules_for(policy, multi_pod, fsdp)


def test_rules_for_rejects_unknown_policy():
    with pytest.raises(ValueError):
        TS.rules_for("pp", multi_pod=False)


NAMES = [None, "batch", "model", "model_kv", "fsdp", "vocab", "seq", "expert",
         ("batch", "seq"), ("fsdp", "model"), "data", "model"]
SHAPES = [(256, 4096, 1024), (32, 4096, 24), (49155, 1024, 8), (3072, 24, 128),
          (512, 49155, 16), (1, 7, 3)]


def _specs(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        out.append(tuple(NAMES[int(i)] for i in rng.integers(0, len(NAMES), k)))
    return out


@pytest.mark.parametrize("policy,multi_pod,fsdp", POLICY)
def test_resolve_spec_equals_reference(policy, multi_pod, fsdp):
    mesh = MESH3 if multi_pod else MESH
    rules = TS.rules_for(policy, multi_pod, fsdp)
    for spec in _specs(POLICY.index((policy, multi_pod, fsdp))):
        for shape in SHAPES + [None]:
            shp = None if shape is None else shape[:len(spec)]
            want = JS.resolve_spec(JP(*spec), rules, mesh, shp)
            got = TS.resolve_spec(TS.P(*spec), rules, mesh, shp)
            assert tuple(got) == tuple(want), (spec, shp)


def test_resolve_spec_safety_rules():
    rules = TS.rules_for("tp", multi_pod=False)
    # A repeated axis: the left entry wins.
    assert TS.resolve_spec(TS.P("model", "model"), rules, MESH, (32, 32)) == TS.P("model", None)
    # 24 heads do not divide 16: dropped; vocab 49155 does not divide: dropped.
    assert TS.resolve_spec(TS.P("fsdp", "model", None), rules, MESH,
                           (3072, 24, 128)) == TS.P(None, None, None)
    assert TS.resolve_spec(TS.P("vocab", None), rules, MESH, (49155, 1024)) == TS.P(None, None)
    # pod last: a batch of 256 claims data before pod.
    rules3 = TS.rules_for("tp", multi_pod=True)
    assert TS.resolve_spec(TS.P("batch", None), rules3, MESH3,
                           (256, 8)) == TS.P(("data", "pod"), None)


def test_placements():
    assert TS.placements(TS.P("data", None, "model"), SMALL) == (Shard(0), Shard(2))
    assert TS.placements(TS.P(None, "model"), SMALL) == (Replicate(), Shard(1))
    assert TS.placements(TS.P(None, None), SMALL) == (Replicate(), Replicate())
    # One tensor dim over two mesh dims: Shard of that dim on both.
    assert TS.placements(TS.P(("data", "model"), None), SMALL) == (Shard(0), Shard(0))
    assert TS.placements(TS.P(("data", "pod"), None), MESH3) == (Shard(0), Shard(0), Replicate())
    assert TS.placements(TS.P(), SMALL) == (Replicate(), Replicate())
    rules = TS.rules_for("tp", multi_pod=False, fsdp=True)
    assert TS.resolve_placements(TS.P("fsdp", "model", None), rules, SMALL,
                                 (64, 4, 8)) == (Shard(0), Shard(1))
    assert TS.resolve_placements(TS.P("fsdp", "model_kv", None), rules, SMALL,
                                 (64, 2, 8)) == (Shard(0), Replicate())


def test_shard_is_a_no_op_without_rules_and_refuses_a_plain_tensor_with_them():
    x = torch.ones(4, 4)
    assert TS.shard(x, "batch", None) is x
    assert TS.shard_tree({"a": x}, {"a": TS.P("batch", None)})["a"] is x
    with TS.active_rules(TS.rules_for("tp", False), SMALL):
        with pytest.raises(TypeError, match="plain"):
            TS.shard(x, "batch", None)
    assert TS.current_context() is None


def _cfg(arch, tiny, full_fn, tiny_fn):
    return tiny_fn(arch) if tiny else full_fn(arch)


def _ref_spec(tree, name, cfg):
    path, index = reference_path(name, cfg)
    s = tree
    for key in path:
        s = s[key]
    s = tuple(s)
    if index is not None:
        assert s[0] is None, (name, s)
        s = s[1:]
    return s


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, tiny):
    tcfg = _cfg(arch, tiny, get_config, tiny_config)
    jcfg = _cfg(arch, tiny, jget, jtiny)
    ref = JT.param_specs(jcfg)
    got = TT.param_specs(tcfg)
    names = [n for n, _ in TT.Transformer(tcfg, device="meta").named_parameters()]
    assert sorted(got) == sorted(names)
    for n in names:
        assert tuple(got[n]) == _ref_spec(ref, n, tcfg), n
    # Every reference leaf is some port parameter's.
    n_ref = len(jax.tree.leaves(ref, is_leaf=lambda x: isinstance(x, JP)))
    assert len({reference_path(n, tcfg)[0] for n in names}) == n_ref


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, tiny):
    tcfg = _cfg(arch, tiny, get_config, tiny_config)
    jcfg = _cfg(arch, tiny, jget, jtiny)
    ref = JT.cache_specs(jcfg)
    got = TT.cache_specs(tcfg)
    assert len(got) == tcfg.n_layers
    for i, layer in enumerate(got):
        for leaf, spec in layer.items():
            assert tuple(spec) == _ref_spec(ref, f"layers.{i}.{leaf}", tcfg), (i, leaf)
    cache = TT.Transformer(tcfg, device="meta").init_cache(2, 16)
    assert [sorted(c) for c in cache] == [sorted(c) for c in got]


def test_opt_state_specs_equal_reference():
    pspec = TT.param_specs(tiny_config("qwen3-32b"))
    got = TO.opt_state_specs(pspec)
    want = JO.opt_state_specs({"x": JP("fsdp", None)})
    assert set(got) == set(want) and tuple(got["step"]) == tuple(want["step"])
    assert got["m"] is pspec and got["v"] is pspec


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "recurrentgemma-9b",
                                  "whisper-small", "paligemma-3b"])
def test_mesh_shardings_bind_every_leaf(arch):
    """``launch.mesh``: the abstract state, batch and cache are meta tensors
    of the real shapes, and each leaf's placements are its resolved spec's."""
    cfg = get_config(arch)
    rules = TM.arch_rules(cfg, multi_pod=False)
    st = TM.abstract_state(cfg)
    assert all(t.device.type == "meta" for t in st["params"].values())
    ss = TM.state_shardings(cfg, MESH, rules)
    specs = TM.state_spec_tree(cfg)
    for n, t in st["params"].items():
        want = TS.placements(TS.resolve_spec(specs["params"][n], rules, MESH,
                                             tuple(t.shape)), MESH)
        assert ss["params"][n] == want == ss["opt"]["m"][n] == ss["opt"]["v"][n]
    assert ss["step"] == TM.replicated(MESH)
    cell = ShapeCell("t", 64, 256, "train")
    bs = TM.batch_shardings(cfg, cell, MESH, rules)
    assert bs["tokens"] == TS.placements(
        TS.resolve_spec(TS.P("batch", None), rules, MESH, (256, 64)), MESH)
    assert bs["tokens"][0] == Shard(0)
    assert set(bs) == set(TM.batch_abstract(cfg, cell))
    cs = TM.cache_shardings(cfg, ShapeCell("d", 64, 128, "decode"), MESH, rules)
    assert len(cs) == cfg.n_layers


def test_granite_full_width_on_the_2x2_mesh():
    """The slice's card check: granite's 32 experts split 2 ways and its 8
    KV heads split.  Its vocab of 49155 is padded to 49664
    (``pad_vocab_to=512``), which the model axis divides, so the embedding
    and the logits split over it too."""
    cfg = get_config("granite-moe-1b-a400m")
    mesh = _mesh((2, 2), ("data", "model"))
    ps = TM.params_shardings(cfg, mesh, TM.arch_rules(cfg, False))
    assert ps["layers.0.ffn.wi"] == (Shard(1), Shard(0))
    assert ps["layers.0.mixer.wk"] == (Shard(0), Shard(1))
    assert cfg.vocab_padded == 49664
    assert ps["embed.table"] == (Replicate(), Shard(0))
    assert ps["embed.head"] == (Shard(0), Shard(1))

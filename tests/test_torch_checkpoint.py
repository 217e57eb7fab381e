"""The port's checkpoint path (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), and ``tests/test_checkpoint.py`` case for
case on the port.

Parity: one reference train state with seeded random moments, converted to
the port (``repro_torch.convert``), saved by both packages' managers under
each consistency model (4 hosts, partner copies).  The save's event ledger,
the manifest JSON, every shard file's bytes and ``CostModel().replay``'s
phases must be equal, and an elastic restore on 3 hosts with host 1 failed
(its rows read from the partner copy) must give the saved tensors bit for bit
and the reference restore's ledger.  States: starcoder2-3b TINY in f32 and in
its own bf16 (bf16 leaves are raw ``uint16`` bits on the port's side),
recurrentgemma-9b TINY (``rem{i}`` blocks beside a 1-deep stack), a
7-layer recurrentgemma (a 2-deep stack and a remainder), granite-moe TINY
(the f32 router and the ``(E, ...)`` experts), whisper TINY in f32 (the
``enc_blocks`` stack, ``cross``, ``norm_c``, ``enc_final_norm``) and
paligemma TINY (``patch_proj``, a top-level leaf).
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import serialization as RS  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as RefManager  # noqa: E402
from repro.configs.registry import tiny_config as jtiny  # noqa: E402
from repro.core.costmodel import CostModel as RefCostModel  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch.checkpoint import serialization as PS  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.registry import tiny_config  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference, params_to_reference,
                                 to_tensor)
from repro_torch.core.basefs import EventKind  # noqa: E402
from repro_torch.core.costmodel import CostModel  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_update  # noqa: E402
from repro_torch.train.train_step import train_state_init  # noqa: E402
from test_torch_core import events, phases  # noqa: E402

MODELS = ("commit", "session", "posix", "mpiio")
# name -> (arch, f32 or the config's own dtype, layers or the tiny depth)
STATES = {"starcoder2-f32": ("starcoder2-3b", True, None),
          "starcoder2-bf16": ("starcoder2-3b", False, None),
          "recurrentgemma-bf16": ("recurrentgemma-9b", False, None),
          "recurrentgemma-7L": ("recurrentgemma-9b", False, 7),
          "granite-bf16": ("granite-moe-1b-a400m", False, None),
          "whisper-f32": ("whisper-small", True, None),
          "paligemma-bf16": ("paligemma-3b", False, None)}
_CACHE = {}


def _both_states(name):
    """(reference host tree, port state) holding the same values."""
    if name not in _CACHE:
        arch, f32, layers = STATES[name]
        jc, tc = jtiny(arch), tiny_config(arch)
        if f32:
            jc = dataclasses.replace(jc, dtype=jnp.float32)
            tc = dataclasses.replace(tc, dtype=torch.float32)
        if layers:
            jc = dataclasses.replace(jc, n_layers=layers)
            tc = dataclasses.replace(tc, n_layers=layers)
        host = jax.device_get(JTS.train_state_init(
            jax.random.PRNGKey(0), jc, JO.AdamWConfig()))
        rng = np.random.default_rng(1)
        for k in ("m", "v"):
            host["opt"][k] = jax.tree.map(
                lambda a: rng.standard_normal(a.shape).astype(a.dtype),
                host["opt"][k])
        host["opt"]["step"] = np.asarray(3, np.int32)
        host["step"] = np.asarray(3, np.int32)
        model = Transformer(tc, device="cpu")
        model.load_state_dict(params_from_reference(host["params"], tc))
        state = {"params": model.requires_grad_(True),
                 "opt": opt_state_from_reference(host["opt"], tc),
                 "step": to_tensor(host["step"])}
        _CACHE[name] = host, state
    return _CACHE[name]


def _leaves(state):
    """Every tensor of a port state, by a name of its own."""
    out = {f"params.{n}": p for n, p in state["params"].named_parameters()}
    for k in ("m", "v"):
        out.update({f"opt.{k}.{n}": t for n, t in state["opt"][k].items()})
    out["opt.step"], out["step"] = state["opt"]["step"], state["step"]
    return out


def _snapshot(state):
    return {n: t.detach().clone() for n, t in _leaves(state).items()}


def assert_bit_equal(state, want):
    got = _leaves(state)
    assert got.keys() == want.keys()
    for n, t in want.items():
        assert got[n].dtype == t.dtype and got[n].shape == t.shape, n
        assert torch.equal(got[n].detach(), t), n


def _file_bytes(mgr, path, node):
    fh = mgr.layer.open(990_000, path, node=node)
    mgr._open_session(fh)
    size = mgr.layer.stat_size(fh)
    mgr.layer.seek(fh, 0)
    return bytes(mgr.layer.read(fh, size))


# --------------------------------------------------------------------------
# serialization against the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(STATES))
def test_flatten_order_arrays_and_manifest_match_reference(name):
    host, state = _both_states(name)
    want, got = RS.flatten_with_paths(host), PS.flatten_with_paths(state)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), k
    assert PS.tree_manifest(state) == RS.tree_manifest(host)
    assert any(m["dtype"] == "bfloat16" for m in PS.tree_manifest(state).values()) \
        == (not STATES[name][1])


@pytest.mark.parametrize("name", sorted(STATES))
def test_params_to_reference_inverts_params_from_reference(name):
    host, state = _both_states(name)
    back = params_to_reference(dict(state["params"].named_parameters()),
                               state["params"].cfg)
    want = dict(RS.flatten_with_paths(host["params"]))
    got = dict(RS.flatten_with_paths(back))
    assert got.keys() == want.keys()
    for k, a in want.items():
        a = np.asarray(a)
        b = got[k]
        if a.dtype.name == "bfloat16":
            assert b.dtype == np.uint16
        assert b.shape == a.shape and b.tobytes() == a.tobytes(), k


def test_to_tensor_keeps_a_0d_array_0d():
    t = to_tensor(np.asarray(3, np.int32))
    assert t.shape == () and t.dtype == torch.int32 and int(t) == 3


def test_serialize_deserialize_roundtrip_makes_a_new_state():
    _, state = _both_states("starcoder2-bf16")
    want = _snapshot(state)
    arrays = {k: torch.from_numpy(a.copy()).view(
        PS.DTYPES[PS.tree_manifest(state)[k]["dtype"]])
        for k, a in PS.serialize_tree(state).items()}
    out = PS.deserialize_tree(state, arrays)
    assert_bit_equal(out, want)
    assert out["params"] is not state["params"]
    assert all(p.requires_grad for p in out["params"].parameters())
    for n, t in _leaves(out).items():
        assert t.data_ptr() != _leaves(state)[n].data_ptr(), n


# --------------------------------------------------------------------------
# save and elastic restore against the reference's, per consistency model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("name", sorted(STATES))
def test_checkpoint_matches_reference(name, model):
    host, state = _both_states(name)
    want_state = _snapshot(state)
    ref = RefManager(model=model, num_hosts=4, partner=True)
    port = CheckpointManager(model=model, num_hosts=4, partner=True)
    ref.save(2, host)
    port.save(2, state)
    assert events(port.fs) == events(ref.fs)
    assert (PS.manifest_to_json(port.manifests[2])
            == RS.manifest_to_json(ref.manifests[2]))
    for engine in ("scalar", "vector"):
        assert (phases(CostModel().replay(port.fs.ledger, engine=engine))
                == phases(RefCostModel().replay(ref.fs.ledger, engine=engine)))

    n_save = len(ref.fs.ledger.events)
    out = port.restore(2, state, num_hosts_new=3, failed_hosts=[1])
    ref.restore(2, host, num_hosts_new=3, failed_hosts=[1])
    assert_bit_equal(out, want_state)
    assert_bit_equal(state, want_state)              # the template is untouched
    assert events(port.fs)[n_save:] == events(ref.fs)[n_save:]
    assert (phases(CostModel().replay(port.fs.ledger))
            == phases(RefCostModel().replay(ref.fs.ledger)))

    paths = [(f"/ckpt/step_2/shard_{h}.bin{sfx}", (h + p) % 4)
             for h in range(4) for sfx, p in (("", 0), (".partner", 1))]
    for path, node in paths + [("/ckpt/step_2/MANIFEST", 0)]:
        assert _file_bytes(port, path, node) == _file_bytes(ref, path, node), path


# --------------------------------------------------------------------------
# tests/test_checkpoint.py, case for case
# --------------------------------------------------------------------------
CFG = dataclasses.replace(tiny_config("qwen3-32b"), dtype=torch.float32)


def _state():
    return train_state_init(torch.Generator().manual_seed(0), CFG,
                            AdamWConfig(state_dtype=CFG.opt_state_dtype), "cpu")


@pytest.mark.parametrize("model", ["commit", "session"])
def test_save_restore_roundtrip(model):
    state = _state()
    mgr = CheckpointManager(model=model, num_hosts=4)
    mgr.save(0, state)
    assert_bit_equal(mgr.restore(0, state), _snapshot(state))


@pytest.mark.parametrize("new_hosts", [1, 2, 3, 6, 8])
def test_elastic_restart_different_host_count(new_hosts):
    state = _state()
    mgr = CheckpointManager(model="session", num_hosts=4)
    mgr.save(3, state)
    assert_bit_equal(mgr.restore(3, state, num_hosts_new=new_hosts),
                     _snapshot(state))


@pytest.mark.parametrize("failed", range(4))
def test_partner_recovery_single_host_failure(failed):
    state = _state()
    mgr = CheckpointManager(model="session", num_hosts=4, partner=True)
    mgr.save(1, state)
    assert_bit_equal(mgr.restore(1, state, failed_hosts=[failed]),
                     _snapshot(state))


def test_failure_without_partner_raises():
    state = _state()
    mgr = CheckpointManager(model="session", num_hosts=2, partner=False)
    mgr.save(0, state)
    with pytest.raises(RuntimeError):
        mgr.restore(0, state, failed_hosts=[0])


def test_flush_release_then_cold_restore_from_pfs():
    state = _state()
    mgr = CheckpointManager(model="commit", num_hosts=2, partner=False)
    mgr.save(7, state)
    mgr.flush(7)
    mgr.release(7)
    assert_bit_equal(mgr.restore(7, state), _snapshot(state))


def test_commit_vs_session_query_gap():
    state = _state()
    counts = {}
    for model in ("commit", "session"):
        mgr = CheckpointManager(model=model, num_hosts=4)
        mgr.save(0, state)
        q0 = mgr.fs.ledger.count(EventKind.RPC, "query")
        mgr.restore(0, state)
        counts[model] = mgr.fs.ledger.count(EventKind.RPC, "query") - q0
    assert counts["commit"] > 4 * counts["session"], counts


def test_manifest_orders_after_shards():
    state = _state()
    mgr = CheckpointManager(model="commit", num_hosts=3, partner=False)
    mgr.save(0, state)
    attaches = [e for e in mgr.fs.ledger.events
                if e.kind is EventKind.RPC and e.rpc_type == "attach"]
    assert attaches, "no attach RPCs recorded"
    assert attaches[-1].client == 0


# --------------------------------------------------------------------------
# restored tensors own their memory, and no host copy outlives its call
# --------------------------------------------------------------------------
def test_save_and_restore_leave_no_cycle_holding_tensors():
    # A reference cycle (a recursive closure over the restore's host
    # arrays) keeps a whole host copy of the state until the collector
    # next runs; at 8 layers of starcoder2-3b that was 10.7 GB.
    state = _state()
    mgr = CheckpointManager(model="session", num_hosts=4)
    gc.collect()
    gc.disable()
    try:
        mgr.save(0, state)
        out = mgr.restore(0, state, num_hosts_new=3, failed_hosts=[1])
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        leaked = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not leaked, f"{len(leaked)} tensors in reference cycles"
    assert_bit_equal(out, _snapshot(state))


def test_in_place_step_on_a_restored_state_leaves_the_checkpoint_intact():
    state = _state()
    want = _snapshot(state)
    mgr = CheckpointManager(model="session", num_hosts=4)
    mgr.save(0, state)
    out = mgr.restore(0, state)
    params = dict(out["params"].named_parameters())
    grads = {n: torch.ones_like(p) for n, p in params.items()}
    adamw_update(grads, out["opt"], params, AdamWConfig())
    assert not torch.equal(params["embed.table"], want["params.embed.table"])
    assert_bit_equal(mgr.restore(0, state), want)

"""The port's sharded paths on a (data=2, model=4) mesh of 8 gloo ranks on
the CPU, against the reference's sharded results.

The reference runs in a subprocess with 8 forced host devices and a mesh of
``Auto`` axes (jax 0.9 makes ``jax.make_mesh`` axes ``Explicit`` by default,
which its ``with_sharding_constraint`` refuses; ``tests/test_multidevice.py``
fails for that reason alone).  Parameters and inputs come from the
reference's initializers in this process, through ``repro_torch.convert``;
the port's 8 ranks (``mp.spawn``, ``torch.set_num_threads(1)``, a
``file://`` rendezvous under the test's tmp dir) run every case once and
write their results, which the tests below hold against the reference's at
the reference test's tolerances:

1. MoE ``a2a`` (granite tiny, no-drop capacity): equal to ``sort_scatter``
   (1e-4), |aux - aux_ref| < 0.5, and equal to the reference's ``a2a``
   (output 1e-4, its per-shard aux 1e-5); two all-to-alls per call.  Its
   train step without the aux term equals the unsharded step (loss 1e-4,
   parameters 5e-4): the a2a backward.
2. qwen3 TINY, f32, 2 microbatches: the sharded train step equals the
   reference's sharded step (loss 1e-4, parameters 5e-4; weight decay 0,
   see ``tests/test_torch_train.py`` for why).
3. recurrentgemma TINY, f32: the sharded forward (5e-4).
4. GQA with 4 query heads over a model axis of 4 and 2 KV heads (qwen3
   TINY): each rank reads the KV head of its own query head (5e-4).
5. ``seq_parallel=True`` (qwen3 TINY): the residual stream sharded over
   the sequence at the block boundaries (5e-4); and granite TINY with its
   ``sort_scatter`` dispatch, which under a mesh runs on each rank's shard
   (5e-4), no collective of its forward gathering the token array.
6. ``compressed_psum`` / ``compressed_psum_ef`` over the data axis: each
   rank's codes equal the reference's under ``shard_map`` exactly, the sums
   within 1e-6, two calls bit-equal.
7. Sharded serving: prefill and 4 decode steps with the caches on their
   ``cache_specs`` placements (qwen3 TINY with a 512-slot cache sharded over
   the sequence, recurrentgemma TINY with its ring, whisper TINY with its
   cross caches) equal the reference's ``make_prefill`` / ``make_serve_step``
   jitted with its ``cache_shardings`` (greedy tokens equal, logits 5e-4);
   the caches keep their placements, and a decode step moves fewer
   collective bytes per rank than its local cache holds (no cache gather).
8. Sharded checkpoints: case 2's sharded state saved under commit and under
   session is byte-equal, manifest included, to rank 0's unsharded save of
   the same state, and restores onto the same placements, shards
   bit-equal.
9. phi3.5 TINY, f32, ``sort_scatter`` on each rank's shard: its sharded
   train step (aux term in the loss) equals the reference's sharded step
   and the unsharded step (loss 1e-4, parameters 5e-4; weight decay 0),
   and so does a step at a capacity that drops slots; its sharded serving
   is case 7's ``phi``.
10. ``kernels.ops.norm`` on DTensors (rows sharded over batch and
    sequence; batch sharded with the features sharded, which are gathered):
    y and the gradients of x, the scale and the bias equal the unsharded
    call's (1e-6).
"""

import dataclasses
import datetime
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import tiny_config as jtiny  # noqa: E402
from repro.data.pipeline import synthetic_batch as jbatch  # noqa: E402
from repro.models.frontends import extra_inputs as jextra  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs.registry import tiny_config  # noqa: E402

SHAPE = (2, 4)
WORLD = SHAPE[0] * SHAPE[1]
CAP = 8.0            # no-drop capacity for the a2a cases
STEPS = 4            # decode steps after the prefill
# (case, arch, its reference parameters' key, cache length)
SERVE = (("qwen", "qwen3-32b", "qwen_p", 512),
         ("rg", "recurrentgemma-9b", "rg_p", 16),
         ("whisper", "whisper-small", "wh_p", 16),
         ("phi", "phi3.5-moe-42b-a6.6b", "phi_p", 16))
DROP_CAP = 0.5       # a capacity at which phi3.5 TINY drops slots
TOL = dict(atol=1e-4, rtol=1e-4)
FWD_TOL = dict(atol=5e-4, rtol=5e-4)
# Case 10's input placements on (data, model): the rows' shards (batch,
# sequence), and the batch's with the features sharded.
NORM_SHARDS = {"rows": (Shard(0), Shard(1)), "features": (Shard(0), Shard(2))}

REFERENCE = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs.registry import tiny_config
    from repro.launch.mesh import batch_shardings, state_shardings
    from repro.models import moe as M, transformer as T
    from repro.models.config import ShapeCell
    from repro.models.sharding import active_rules, rules_for
    from repro.train import grad_compress as G
    from repro.train.optimizer import AdamWConfig
    from repro.train.train_step import make_train_step

    inp = pickle.load(open(sys.argv[1], "rb"))
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = rules_for("tp", multi_pod=False)
    f32 = jnp.float32
    out = {}

    cfg = dataclasses.replace(tiny_config("granite-moe-1b-a400m"), dtype=f32,
                              moe_capacity=%(cap)r, moe_impl="a2a")
    with mesh, active_rules(rules, mesh):
        y, aux = jax.jit(lambda p, x: M.moe_forward(p, x, cfg))(
            inp["moe_p"], inp["moe_x"])
    out["a2a_y"], out["a2a_aux"] = np.asarray(y), float(aux)

    cfg = dataclasses.replace(tiny_config("qwen3-32b"), dtype=f32)
    opt = AdamWConfig(weight_decay=0.0)
    step = make_train_step(cfg, opt, num_microbatches=2)
    state = {"params": inp["qwen_p"],
             "opt": {"m": jax.tree.map(jnp.zeros_like, inp["qwen_p"]),
                     "v": jax.tree.map(jnp.zeros_like, inp["qwen_p"]),
                     "step": jnp.zeros((), jnp.int32)},
             "step": jnp.zeros((), jnp.int32)}
    with mesh, active_rules(rules, mesh):
        ss = state_shardings(cfg, mesh, rules)
        bs = batch_shardings(cfg, ShapeCell("t", 16, 8, "train"), mesh, rules)
        s, m = jax.jit(step, in_shardings=(ss, bs), out_shardings=(ss, None))(
            state, inp["qwen_batch"])
    out["train_loss"] = float(m["loss"])
    out["train_params"] = jax.device_get(s["params"])

    pcfg = dataclasses.replace(tiny_config("phi3.5-moe-42b-a6.6b"), dtype=f32)
    pstep = make_train_step(pcfg, opt, num_microbatches=1)
    pstate = {"params": inp["phi_p"],
              "opt": {"m": jax.tree.map(jnp.zeros_like, inp["phi_p"]),
                      "v": jax.tree.map(jnp.zeros_like, inp["phi_p"]),
                      "step": jnp.zeros((), jnp.int32)},
              "step": jnp.zeros((), jnp.int32)}
    with mesh, active_rules(rules, mesh):
        ss = state_shardings(pcfg, mesh, rules)
        bs = batch_shardings(pcfg, ShapeCell("t", 12, 8, "train"), mesh, rules)
        s, m = jax.jit(pstep, in_shardings=(ss, bs), out_shardings=(ss, None))(
            pstate, inp["phi_batch"])
    out["phi_loss"] = float(m["loss"])
    out["phi_params"] = jax.device_get(s["params"])

    def fwd(cfg, params, toks):
        with mesh, active_rules(rules, mesh):
            lg, _ = jax.jit(lambda p, t: T.forward(p, t, cfg))(params, toks)
        return np.asarray(lg)

    out["rg_logits"] = fwd(dataclasses.replace(tiny_config("recurrentgemma-9b"),
                                               dtype=f32), inp["rg_p"], inp["toks"])
    out["gqa_logits"] = fwd(cfg, inp["qwen_p"], inp["toks"])
    out["sp_logits"] = fwd(dataclasses.replace(cfg, seq_parallel=True),
                           inp["qwen_p"], inp["sp_toks"])
    out["moe_logits"] = fwd(dataclasses.replace(tiny_config("granite-moe-1b-a400m"),
                                                dtype=f32), inp["granite_p"], inp["toks"])

    try:
        shard_map = jax.shard_map
    except AttributeError:
        from jax.experimental.shard_map import shard_map

    def local(x, err):
        q, s = G.compress(x)
        tot = G.compressed_psum(x, "data")
        tot_ef, new_err = G.compressed_psum_ef(x, err, "data")
        return q[None], s[None], tot[None], tot_ef[None], new_err[None]

    spec = P("data")
    fn = shard_map(local, mesh=mesh, in_specs=(spec, spec), out_specs=(spec,) * 5,
                   check_vma=False)
    q, s, tot, tot_ef, new_err = jax.jit(fn)(inp["cp_x"], inp["cp_err"])
    out["cp"] = [np.asarray(a) for a in (q, s, tot, tot_ef, new_err)]

    from repro.launch.mesh import cache_shardings
    from repro.serve.decode import make_prefill, make_serve_step

    def serve(cfg, params, toks, max_len, **extras):
        cell = ShapeCell("s", max_len, toks.shape[0], "decode")
        res = {"logits": [], "tokens": []}
        with mesh, active_rules(rules_for(cfg.policy, False), mesh):
            csh = cache_shardings(cfg, cell, mesh, rules_for(cfg.policy, False))
            pf = jax.jit(make_prefill(cfg, max_len), out_shardings=(None, None, csh))
            st = jax.jit(make_serve_step(cfg), out_shardings=(None, None, csh))
            tok, logits, cache = pf(params, toks, **extras)
            for i in range(%(steps)d + 1):
                res["logits"].append(np.asarray(logits))
                res["tokens"].append(np.asarray(tok))
                if i < %(steps)d:
                    tok, logits, cache = st(params, cache, tok[:, None],
                                            jnp.int32(toks.shape[1] + i))
        return res

    for name, arch, key, max_len in %(serve)r:
        cfg = dataclasses.replace(tiny_config(arch), dtype=f32)
        extras = {"frames": inp["wh_frames"]} if name == "whisper" else {}
        out["serve_" + name] = serve(cfg, inp[key], inp["serve_toks"], max_len,
                                     **extras)
    pickle.dump(out, open(sys.argv[2], "wb"))
""") % {"cap": CAP, "steps": STEPS, "serve": SERVE}


def _ranks(rank: int, inputs: str, rendezvous: str, outdir: str) -> None:
    """One rank of the port: every case on the (2, 4) mesh."""
    import torch.distributed as dist

    from repro_torch.convert import params_from_reference, to_tensor
    from repro_torch.launch import mesh as MS
    from repro_torch.models import moe as TM
    from repro_torch.models import sharding as sh
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.train import grad_compress as gc
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step, train_state_init

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=300))
    inp = pickle.load(open(inputs, "rb"))
    mesh = MS.make_mesh(SHAPE, ("data", "model"), "cpu")
    f32 = torch.float32
    out = {}

    def model(cfg, tree):
        m = Transformer(cfg, device="cpu")
        m.load_state_dict(params_from_reference(tree, cfg))
        return m

    def sharded_forward(cfg, tree, toks, issued=None):
        from repro_torch.launch.hlostats import StepCounter
        m = model(cfg, tree)
        rules = MS.arch_rules(cfg, False)
        sh.distribute_model(m, MS.T.param_specs(cfg), rules, mesh)
        with sh.active_rules(rules, mesh), torch.no_grad():
            t = MS.distribute_batch({"t": torch.from_numpy(toks).long()}, mesh, rules)
            with StepCounter() as count:
                logits = m(t["t"])[0]
            if issued is not None:
                issued.extend(count.issued)
            return logits.full_tensor().numpy()

    # 1. MoE a2a against sort_scatter, and its step without the aux term.
    cfg = dataclasses.replace(tiny_config("granite-moe-1b-a400m"), dtype=f32,
                              moe_capacity=CAP, moe_impl="a2a")
    rules = MS.arch_rules(cfg, False)
    p = {k: to_tensor(v) for k, v in inp["moe_p"].items()}
    x = to_tensor(inp["moe_x"])
    B, T, D = x.shape
    y_ss, aux_ss = TM._moe_local(x.reshape(-1, D), p, cfg, TM.capacity(cfg, B * T))
    out["ss_y"], out["ss_aux"] = y_ss.reshape(x.shape).numpy(), float(aux_ss)
    TM.A2A_CALLS = 0
    with sh.active_rules(rules, mesh):
        pd = sh.distribute_tree(p, TM.moe_spec(cfg), rules, mesh)
        xd = sh.distribute(x, sh.P("batch", None, None), rules, mesh)
        y, aux = TM.moe_forward(pd, xd, cfg)
        out["a2a_y"], out["a2a_aux"] = y.full_tensor().numpy(), float(aux.full_tensor())
    out["a2a_calls"] = TM.A2A_CALLS
    opt = AdamWConfig(weight_decay=0.0)
    step = make_train_step(cfg, opt, num_microbatches=1, aux_weight=0.0)
    batch = {k: torch.from_numpy(v).long() for k, v in inp["moe_batch"].items()}
    plain, pm = step(train_state_init(torch.Generator().manual_seed(0), cfg, opt,
                                      "cpu"), batch)
    st = MS.sharded_train_state(init_params(cfg, torch.Generator().manual_seed(0),
                                            "cpu"), cfg, opt, mesh, rules)
    with sh.active_rules(rules, mesh):
        shd, sm = step(st, MS.distribute_batch(batch, mesh, rules))
    out["a2a_step"] = (float(pm["loss"]), float(sm["loss"]), max(
        float((a - b.full_tensor()).detach().abs().max())
        for (_, a), (_, b) in zip(plain["params"].named_parameters(),
                                  shd["params"].named_parameters())))

    # 2. qwen3 TINY, M=2: the sharded train step.
    cfg = dataclasses.replace(tiny_config("qwen3-32b"), dtype=f32)
    rules = MS.arch_rules(cfg, False)
    state = MS.sharded_train_state(model(cfg, inp["qwen_p"]), cfg, opt, mesh, rules)
    batch = {k: torch.from_numpy(v).long() for k, v in inp["qwen_batch"].items()}
    with sh.active_rules(rules, mesh):
        new, met = make_train_step(cfg, opt, num_microbatches=2)(
            state, MS.distribute_batch(batch, mesh, rules))
    out["train_loss"] = float(met["loss"])
    out["train_params"] = {n: t.full_tensor().detach().numpy()
                           for n, t in new["params"].named_parameters()}

    # 9. phi3.5 TINY: sort_scatter on each rank's shard, the aux term in the
    # loss; the sharded step against the unsharded one, at the config's
    # capacity and at one that drops slots.
    from repro_torch.train.optimizer import adamw_init

    def fresh(cfg, tree):
        m = model(cfg, tree).requires_grad_(True)
        return {"params": m, "opt": adamw_init(dict(m.named_parameters()), opt),
                "step": torch.zeros((), dtype=torch.int32)}

    pbatch = {k: torch.from_numpy(v).long() for k, v in inp["phi_batch"].items()}
    for key, cap in (("phi", None), ("phi_drop", DROP_CAP)):
        pcfg = dataclasses.replace(tiny_config("phi3.5-moe-42b-a6.6b"), dtype=f32)
        if cap is not None:
            pcfg = dataclasses.replace(pcfg, moe_capacity=cap)
        prules = MS.arch_rules(pcfg, False)
        pstep = make_train_step(pcfg, opt, num_microbatches=1)
        plain, pm = pstep(fresh(pcfg, inp["phi_p"]), pbatch)
        st = MS.sharded_train_state(model(pcfg, inp["phi_p"]), pcfg, opt, mesh, prules)
        with sh.active_rules(prules, mesh):
            shd, sm = pstep(st, MS.distribute_batch(pbatch, mesh, prules))
        out[key] = {"loss": float(sm["loss"]), "plain_loss": float(pm["loss"]),
                    "aux": float(sm["moe_aux"]), "plain_aux": float(pm["moe_aux"]),
                    "params": {n: t.full_tensor().detach().numpy()
                               for n, t in shd["params"].named_parameters()},
                    "plain_params": {n: t.detach().numpy()
                                     for n, t in plain["params"].named_parameters()}}

    # 3.-5. Sharded forwards.
    out["rg_logits"] = sharded_forward(
        dataclasses.replace(tiny_config("recurrentgemma-9b"), dtype=f32),
        inp["rg_p"], inp["toks"])
    out["gqa_logits"] = sharded_forward(cfg, inp["qwen_p"], inp["toks"])
    out["sp_logits"] = sharded_forward(dataclasses.replace(cfg, seq_parallel=True),
                                       inp["qwen_p"], inp["sp_toks"])
    out["moe_issued"] = []
    out["moe_logits"] = sharded_forward(
        dataclasses.replace(tiny_config("granite-moe-1b-a400m"), dtype=f32),
        inp["granite_p"], inp["toks"], out["moe_issued"])

    # 6. compressed_psum over the data axis.
    d = mesh.get_coordinate()[0]
    n = inp["cp_x"].shape[0] // SHAPE[0]
    xl = torch.from_numpy(inp["cp_x"][d * n:(d + 1) * n])
    el = torch.from_numpy(inp["cp_err"][d * n:(d + 1) * n])
    q, s = gc.compress(xl)
    tot = gc.compressed_psum(xl, mesh, "data")
    tot_ef, new_err = gc.compressed_psum_ef(xl, el, mesh, "data")
    out["cp"] = [t.numpy() for t in (q, s, tot, tot_ef, new_err)]
    out["cp_twice"] = bool(torch.equal(tot, gc.compressed_psum(xl, mesh, "data")))
    out["cp_data"] = d

    # 7. Sharded serving.
    from repro_torch.launch.hlostats import StepCounter
    from repro_torch.serve.decode import make_prefill, make_serve_step

    def serve(cfg, tree, toks, max_len, **extras):
        m = model(cfg, tree)
        rules = MS.arch_rules(cfg, False)
        sh.distribute_model(m, MS.T.param_specs(cfg), rules, mesh)
        res = {"logits": [], "tokens": []}
        with sh.active_rules(rules, mesh), torch.no_grad():
            b = MS.distribute_batch({"tokens": torch.from_numpy(toks).long(),
                                     **{k: torch.from_numpy(v) for k, v in extras.items()}},
                                    mesh, rules)
            tok, logits, cache = make_prefill(m, max_len)(
                b["tokens"], **{k: b[k] for k in extras})
            want = [{k: tuple(t.placements) for k, t in c.items()} for c in
                    m.init_cache(toks.shape[0], max_len)]
            step = make_serve_step(m)
            for i in range(STEPS + 1):
                res["logits"].append(logits.full_tensor().numpy())
                res["tokens"].append(tok.full_tensor().numpy())
                res.setdefault("kept", []).append(want == [
                    {k: tuple(t.placements) for k, t in c.items()} for c in cache])
                if i < STEPS:
                    with StepCounter() as count:
                        tok, logits, cache = step(cache, tok[:, None],
                                                  toks.shape[1] + i)
                    res.setdefault("wire", []).append(count.collectives.payload_bytes)
            res["local_cache"] = sum(t.to_local().numel() * t.to_local().element_size()
                                     for c in cache for t in c.values())
        return res

    for name, arch, key, max_len in SERVE:
        cfg = dataclasses.replace(tiny_config(arch), dtype=f32)
        extras = {"frames": inp["wh_frames"]} if name == "whisper" else {}
        out["serve_" + name] = serve(cfg, inp[key], inp["serve_toks"], max_len,
                                     **extras)

    # 8. Sharded checkpoints of case 2's state.
    from repro_torch.checkpoint.manager import CheckpointManager
    cfg = dataclasses.replace(tiny_config("qwen3-32b"), dtype=f32)
    whole = None
    if rank == 0:
        whole = Transformer(cfg, device="cpu")
    full = {n: t.full_tensor().detach() for n, t in new["params"].named_parameters()}
    moments = {k: {n: t.full_tensor() for n, t in new["opt"][k].items()}
               for k in ("m", "v")}
    if rank == 0:
        whole.load_state_dict(full)
        whole = {"params": whole.requires_grad_(True),
                 "opt": {**moments, "step": new["opt"]["step"].clone()},
                 "step": new["step"].clone()}
    ck = {}
    for cm in ("commit", "session"):
        mgr = CheckpointManager(model=cm, num_hosts=4, partner=True)
        manifest = mgr.save(2, new)
        back = mgr.restore(2, new, num_hosts_new=3, failed_hosts=[1])
        pairs = [(a, b) for (_, a), (_, b) in zip(new["params"].named_parameters(),
                                                  back["params"].named_parameters())]
        pairs += [(new["opt"][k][n], back["opt"][k][n]) for k in ("m", "v")
                  for n in new["opt"][k]]
        pairs += [(new["opt"]["step"], back["opt"]["step"]), (new["step"], back["step"])]
        same = all(type(a) is type(b) and (
            tuple(a.placements) == tuple(b.placements)
            and torch.equal(a.to_local(), b.to_local()) if hasattr(a, "placements")
            else torch.equal(a, b)) for a, b in pairs)
        res = {"restored": same, "manifest": manifest}
        if rank == 0:
            plain = CheckpointManager(model=cm, num_hosts=4, partner=True)
            plain.save(2, whole)
            paths = [(f"/ckpt/step_2/shard_{h}.bin{sfx}", (h + p) % 4)
                     for h in range(4) for sfx, p in (("", 0), (".partner", 1))]
            res["bytes_equal"] = all(
                _file_bytes(mgr, path, node) == _file_bytes(plain, path, node)
                for path, node in paths + [("/ckpt/step_2/MANIFEST", 0)])
            res["plain_manifest"] = plain.manifests[2]
        ck[cm] = res
    out["ckpt"] = ck

    # 10. kernels.ops.norm on DTensors: rows keep their shards (the batch on
    # data, the sequence on model), a feature dim sharded on model is
    # gathered; the scale's and bias's gradients are Partial over the row
    # shards and come out whole.
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops as K
    nx, ns, nb, ndy = (torch.from_numpy(inp[k])
                       for k in ("norm_x", "norm_s", "norm_b", "norm_dy"))
    whole = (Replicate(),) * 2
    for case, pl in NORM_SHARDS.items():
        for kind in ("layernorm", "rmsnorm"):
            leaves = [distribute_tensor(nx, mesh, pl).requires_grad_(),
                      distribute_tensor(ns, mesh, whole).requires_grad_()]
            if kind == "layernorm":
                leaves.append(distribute_tensor(nb, mesh, whole).requires_grad_())
            y = K.norm(*leaves[:2], leaves[2] if kind == "layernorm" else None, kind)
            grads = torch.autograd.grad(y, leaves, distribute_tensor(ndy, mesh, y.placements))
            out[f"norm_{case}_{kind}"] = (tuple(map(str, y.placements)),
                                          y.full_tensor().detach().numpy(),
                                          [g.full_tensor().numpy() for g in grads])
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _file_bytes(mgr, path, node):
    fh = mgr.layer.open(990_000, path, node=node)
    mgr._open_session(fh)
    size = mgr.layer.stat_size(fh)
    mgr.layer.seek(fh, 0)
    return bytes(mgr.layer.read(fh, size))


def _inputs():
    """Reference parameters and seeded inputs, as numpy trees."""
    get = jax.device_get
    f32 = jnp.float32
    cfg = dataclasses.replace(jtiny("granite-moe-1b-a400m"), dtype=f32,
                              moe_capacity=CAP, moe_impl="a2a")
    moe_p = get(JM.moe_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    qcfg = dataclasses.replace(jtiny("qwen3-32b"), dtype=f32)
    qp = get(JT.init_params(jax.random.PRNGKey(0), qcfg))
    rcfg = dataclasses.replace(jtiny("recurrentgemma-9b"), dtype=f32)
    wcfg = dataclasses.replace(jtiny("whisper-small"), dtype=f32)
    pcfg = dataclasses.replace(jtiny("phi3.5-moe-42b-a6.6b"), dtype=f32)
    return {
        "wh_p": get(JT.init_params(jax.random.PRNGKey(2), wcfg)),
        "wh_frames": np.asarray(get(jextra(wcfg, 8, key=jax.random.PRNGKey(4))["frames"])),
        "serve_toks": rng.integers(0, 128, (8, 12)).astype(np.int32),
        "moe_p": moe_p,
        "moe_x": rng.standard_normal((8, 4, cfg.d_model)).astype(np.float32),
        "moe_batch": {k: np.asarray(v) for k, v in get(jbatch(
            jax.random.PRNGKey(3), cfg, 8, 8)).items()},
        "qwen_p": qp,
        "qwen_batch": {k: np.asarray(v) for k, v in get(jbatch(
            jax.random.PRNGKey(1), qcfg, 8, 16)).items()},
        "rg_p": get(JT.init_params(jax.random.PRNGKey(0), rcfg)),
        "granite_p": get(JT.init_params(jax.random.PRNGKey(0), dataclasses.replace(
            jtiny("granite-moe-1b-a400m"), dtype=f32))),
        "phi_p": get(JT.init_params(jax.random.PRNGKey(5), pcfg)),
        "phi_batch": {k: np.asarray(v) for k, v in get(jbatch(
            jax.random.PRNGKey(6), pcfg, 8, 12)).items()},
        "toks": rng.integers(0, 128, (8, 12)).astype(np.int32),
        "sp_toks": rng.integers(0, 128, (8, 16)).astype(np.int32),
        "cp_x": rng.standard_normal((4, 1500)).astype(np.float32),
        "cp_err": (0.01 * rng.standard_normal((4, 1500))).astype(np.float32),
        "norm_x": (2 * rng.standard_normal((4, 8, 16)) + 0.5).astype(np.float32),
        "norm_s": (1 + 0.1 * rng.standard_normal(16)).astype(np.float32),
        "norm_b": (0.1 * rng.standard_normal(16)).astype(np.float32),
        "norm_dy": rng.standard_normal((4, 8, 16)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's results, each port rank's results)."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp / "inputs.pkl"),
                            str(tmp / "ref.pkl")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(_ranks, args=(str(tmp / "inputs.pkl"), str(tmp / "rendezvous"),
                               str(tmp)), nprocs=WORLD)
        _, err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return inp, want, ranks


def test_a2a_equals_sort_scatter_and_the_reference_a2a(runs):
    _, want, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got["a2a_y"], got["ss_y"], **TOL)
        assert abs(got["a2a_aux"] - got["ss_aux"]) < 0.5
        np.testing.assert_allclose(got["a2a_y"], want["a2a_y"], **TOL)
        assert abs(got["a2a_aux"] - want["a2a_aux"]) < 1e-5
        assert got["a2a_calls"] == 2


def test_a2a_train_step_without_aux_equals_unsharded(runs):
    """The aux term is left out: the a2a aux is the mean of per-shard
    estimators (the reference's ``pmean``), another function than the
    unsharded step's global one."""
    for got in runs[2]:
        plain, shd, dparam = got["a2a_step"]
        assert abs(plain - shd) < 1e-4 and dparam < 5e-4


def test_sharded_train_step_equals_reference(runs):
    from repro_torch.convert import reference_leaf
    _, want, ranks = runs
    cfg = tiny_config("qwen3-32b")
    for got in ranks:
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], **TOL)
        for n, a in got["train_params"].items():
            np.testing.assert_allclose(a, reference_leaf(want["train_params"], n, cfg),
                                       atol=5e-4, rtol=5e-4, err_msg=n)


@pytest.mark.parametrize("case", ["rg_logits", "gqa_logits", "sp_logits",
                                  "moe_logits"])
def test_sharded_forward_equals_reference(runs, case):
    _, want, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got[case], want[case], **FWD_TOL)


def test_sort_scatter_forward_gathers_no_token_array(runs):
    """Case 5's granite TINY forward: no all-gather outputs the MoE
    layer's (B, T, D) input, as the replicated dispatch's did."""
    inp, _, ranks = runs
    B, T = inp["toks"].shape
    D = tiny_config("granite-moe-1b-a400m").d_model
    for got in ranks:
        gathers = [tuple(shape) for kind, _, shape in got["moe_issued"]
                   if kind == "all-gather"]
        assert gathers and (B, T, D) not in gathers, gathers


def test_phi_sort_scatter_train_step_equals_reference(runs):
    from repro_torch.convert import reference_leaf
    _, want, ranks = runs
    cfg = tiny_config("phi3.5-moe-42b-a6.6b")
    for got in ranks:
        np.testing.assert_allclose(got["phi"]["loss"], want["phi_loss"], **TOL)
        for n, a in got["phi"]["params"].items():
            np.testing.assert_allclose(a, reference_leaf(want["phi_params"], n, cfg),
                                       atol=5e-4, rtol=5e-4, err_msg=n)


@pytest.mark.parametrize("key", ["phi", "phi_drop"])
def test_phi_sort_scatter_train_step_equals_unsharded(runs, key):
    """The global capacity, slot order and drops: the aux term included, at
    the config's capacity and at one that drops slots."""
    for got in runs[2]:
        res = got[key]
        assert abs(res["loss"] - res["plain_loss"]) < 1e-4
        assert abs(res["aux"] - res["plain_aux"]) < 1e-5
        for n, a in res["params"].items():
            np.testing.assert_allclose(a, res["plain_params"][n], atol=5e-4, rtol=5e-4,
                                       err_msg=n)


def test_compressed_psum_equals_reference(runs):
    _, want, ranks = runs
    for got in ranks:
        d = got["cp_data"]
        q, s, tot, tot_ef, new_err = got["cp"]
        wq, ws, wtot, wtot_ef, wnew_err = (a[d] for a in want["cp"])
        np.testing.assert_array_equal(q, wq)
        np.testing.assert_allclose(s, ws, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tot, wtot, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tot_ef, wtot_ef, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(new_err, wnew_err, atol=1e-6, rtol=1e-6)
        assert got["cp_twice"]


@pytest.mark.parametrize("case", [c[0] for c in SERVE])
def test_sharded_serving_equals_reference(runs, case):
    _, want, ranks = runs
    w = want["serve_" + case]
    for got in ranks:
        g = got["serve_" + case]
        assert len(g["tokens"]) == len(w["tokens"]) == STEPS + 1
        for a, b in zip(g["tokens"], w["tokens"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(g["logits"], w["logits"]):
            np.testing.assert_allclose(a, b, **FWD_TOL)
        assert all(g["kept"])
        if case == "qwen":        # the cache sharded over the sequence
            assert max(g["wire"]) < g["local_cache"], (g["wire"], g["local_cache"])


def test_sharded_checkpoint_is_an_unsharded_one(runs):
    ranks = runs[2]
    for got in ranks:
        for cm in ("commit", "session"):
            res = got["ckpt"][cm]
            assert res["restored"], cm
            assert res["manifest"] == ranks[0]["ckpt"][cm]["plain_manifest"], cm
    assert all(ranks[0]["ckpt"][cm]["bytes_equal"] for cm in ("commit", "session"))


@pytest.mark.parametrize("case", list(NORM_SHARDS))
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_on_shards_equals_unsharded(runs, case, kind):
    """Case 10: y, dx, dscale (and dbias) of ``ops.norm`` on each rank's
    row shards equal the unsharded call's (1e-6: the scale's gradient is
    summed over the ranks' rows in another order); y keeps the rows'
    shards, a sharded feature dim comes out whole."""
    from repro_torch.kernels import ops as K
    inp, _, ranks = runs
    leaves = [torch.from_numpy(inp[k]).requires_grad_() for k in ("norm_x", "norm_s")]
    if kind == "layernorm":
        leaves.append(torch.from_numpy(inp["norm_b"]).requires_grad_())
    y = K.norm(*leaves[:2], leaves[2] if kind == "layernorm" else None, kind)
    want = torch.autograd.grad(y, leaves, torch.from_numpy(inp["norm_dy"]))
    kept = {"rows": ("S(0)", "S(1)"), "features": ("S(0)", "R")}[case]
    for got in ranks:
        placements, gy, grads = got[f"norm_{case}_{kind}"]
        assert placements == kept
        np.testing.assert_allclose(gy, y.detach().numpy(), atol=1e-6, rtol=1e-6)
        assert len(grads) == len(want)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g, w.numpy(), atol=1e-6, rtol=1e-6)


def test_launch_train_mesh_single_runs_unsharded_below_256_ranks(capsys):
    from repro_torch.launch import train
    argv = ["--arch", "qwen3-32b", "--tiny", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "16"]
    base = train.run(argv + ["--mesh", "none"])
    for mesh, need in (("single", 256), ("multi", 512)):
        capsys.readouterr()
        got = train.run(argv + ["--mesh", mesh])
        assert (f"[launch] {need} devices required for --mesh {mesh}, have 1; "
                "running unsharded (same numerics).") in capsys.readouterr().out
        assert got.losses == base.losses

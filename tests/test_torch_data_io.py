"""The port's data ingest (``repro_torch.data``), workloads and SCR
(``repro_torch.io``) against the reference's, on the CPU.

* ``PreloadedStore`` preload and ``run_epoch`` under all four models, bulk
  and scalar, on synthetic and real samples: every ``Event`` field,
  ``EpochStats`` and ``CostModel().replay``'s phases (scalar and vector
  engines) equal.
* The Fig. 6 fast grid (``benchmarks/fig6_dl.py``: hosts 2 and 4, strong
  and weak scaling, 116 KiB samples, 4 readers a host): each row equal to
  the reference's, and session's modelled read bandwidth above commit's.
* ``make_token_samples`` from the int the reference derives from its key;
  ``TokenPipeline`` batches of epochs 0 and 1 and the ledger they leave;
  one f32 starcoder2 train step on the first pipeline batch from converted
  parameters, at ``tests/test_torch_train.py``'s tolerances.
* ``run_workload`` for every workload builder and ``run_scr`` with and
  without a seeded ``FaultSchedule``: ledgers (or, for SCR, the lifted
  formal execution) and results equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.analysis.trace as ref_trace  # noqa: E402
import repro.core.basefs as ref_basefs  # noqa: E402
import repro.core.costmodel as ref_costmodel  # noqa: E402
import repro.core.faults as ref_faults  # noqa: E402
import repro.data.dlio as ref_dlio  # noqa: E402
import repro.data.pipeline as ref_pipeline  # noqa: E402
import repro.io.scr as ref_scr  # noqa: E402
import repro.io.workloads as ref_workloads  # noqa: E402
import repro_torch.analysis.trace as port_trace  # noqa: E402
import repro_torch.core.basefs as port_basefs  # noqa: E402
import repro_torch.core.costmodel as port_costmodel  # noqa: E402
import repro_torch.core.faults as port_faults  # noqa: E402
import repro_torch.data.dlio as port_dlio  # noqa: E402
import repro_torch.data.pipeline as port_pipeline  # noqa: E402
import repro_torch.io.scr as port_scr  # noqa: E402
import repro_torch.io.workloads as port_workloads  # noqa: E402
from benchmarks import fig6_dl  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402
from repro_torch.convert import reference_leaf  # noqa: E402
from repro_torch.examples.train_checkpoint import SAMPLE_SEED  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from test_torch_core import MODELS, _plain, events, phases  # noqa: E402
from test_torch_train import TOL, _both_states  # noqa: E402

REF = {"dlio": ref_dlio, "pipeline": ref_pipeline, "basefs": ref_basefs,
       "costmodel": ref_costmodel, "workloads": ref_workloads,
       "scr": ref_scr, "faults": ref_faults, "trace": ref_trace}
PORT = {"dlio": port_dlio, "pipeline": port_pipeline, "basefs": port_basefs,
        "costmodel": port_costmodel, "workloads": port_workloads,
        "scr": port_scr, "faults": port_faults, "trace": port_trace}


def fields(x):
    """A dataclass's fields, enums by value: comparable across packages."""
    return tuple(_plain(getattr(x, f.name)) for f in dataclasses.fields(x))


def replays(pkg, fs):
    return [phases(pkg["costmodel"].CostModel().replay(fs.ledger, engine=e))
            for e in ("scalar", "vector")]


# --------------------------------------------------------------------------
# PreloadedStore
# --------------------------------------------------------------------------
def _epochs(pkg, model, bulk, real):
    samples = ([np.full((64,), i, np.int32) + np.arange(64, dtype=np.int32)
                for i in range(24)] if real else None)
    store = pkg["dlio"].PreloadedStore(model, num_hosts=3, samples_per_host=8,
                                       sample_bytes=256, procs_per_host=2,
                                       samples=samples)
    store.preload()
    stats = [fields(store.run_epoch(e, bulk=bulk)) for e in (0, 1)]
    return store.fs, stats


@pytest.mark.parametrize("real", [False, True], ids=["pattern", "arrays"])
@pytest.mark.parametrize("bulk", [True, False], ids=["bulk", "scalar"])
@pytest.mark.parametrize("model", MODELS)
def test_preloaded_store_epochs_match_the_reference(model, bulk, real):
    ref_fs, ref_stats = _epochs(REF, model, bulk, real)
    port_fs, port_stats = _epochs(PORT, model, bulk, real)
    assert port_stats == ref_stats
    assert ref_stats[0][1] == 24                   # samples_read
    assert events(port_fs) == events(ref_fs)
    assert replays(PORT, port_fs) == replays(REF, ref_fs)


def _fig6_row(pkg, model, hosts, n_local):
    """``benchmarks/fig6_dl.py``'s ``_run_store`` on ``pkg``'s modules."""
    store = pkg["dlio"].PreloadedStore(model, hosts, n_local,
                                       sample_bytes=fig6_dl.SAMPLE,
                                       procs_per_host=fig6_dl.PROCS)
    store.preload()
    stats = store.run_epoch(0)
    store.fs.drain()
    epoch = [p for p in pkg["costmodel"].CostModel().replay(store.fs.ledger)
             if p.name == "epoch_0"][0]
    return {"model": model, "hosts": hosts, "shards": 1,
            "samples": stats.samples_read,
            "read_bw": round(epoch.io_bandwidth),
            "local_frac": round(stats.local_reads / stats.samples_read, 3),
            "queries": stats.queries}


@pytest.mark.parametrize("hosts", fig6_dl.HOSTS[:2])
@pytest.mark.parametrize("scaling", ["strong", "weak"])
def test_fig6_fast_grid_matches_the_reference(scaling, hosts):
    n_local = (max(fig6_dl.STRONG_TOTAL // hosts, fig6_dl.PROCS)
               if scaling == "strong" else fig6_dl.WEAK_PER_PROC * fig6_dl.PROCS)
    rows = {}
    for model in ("commit", "session"):
        want = fig6_dl._run_store(model, hosts, n_local)
        rows[model] = _fig6_row(PORT, model, hosts, n_local)
        assert rows[model] == want
    # The paper's Fig. 6 gap: one query per sample under commit, one per
    # (reader, source host) under session, and more modelled bandwidth.
    assert rows["commit"]["queries"] == rows["commit"]["samples"]
    assert rows["session"]["queries"] <= hosts * hosts * fig6_dl.PROCS
    assert rows["session"]["read_bw"] > rows["commit"]["read_bw"]


# --------------------------------------------------------------------------
# make_token_samples, TokenPipeline, a train step on its batch
# --------------------------------------------------------------------------
def test_make_token_samples_matches_the_reference():
    key = jax.random.PRNGKey(0)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    assert seed == SAMPLE_SEED
    want = ref_pipeline.make_token_samples(key, 16, 13, 300)
    got = port_pipeline.make_token_samples(seed, 16, 13, 300)
    assert len(got) == 16
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def _pipeline(pkg, model, cfg, seq=12, B=4, **kw):
    """A 2-host store of 16 samples of ``seq + 1`` tokens, preloaded, and a
    TokenPipeline over it; the samples come from each package's own
    ``make_token_samples`` with the same seed."""
    seed = jax.random.PRNGKey(0) if pkg is REF else SAMPLE_SEED
    samples = pkg["pipeline"].make_token_samples(seed, 16, seq + 1, cfg.vocab)
    store = pkg["dlio"].PreloadedStore(model, num_hosts=2, samples_per_host=8,
                                       procs_per_host=1, samples=samples)
    store.preload()
    return store, pkg["pipeline"].TokenPipeline(store, cfg, B, seq, **kw)


@pytest.mark.parametrize("model", MODELS)
def test_token_pipeline_matches_the_reference(model):
    jc, tc = _both_states("starcoder2-3b", 0.0)[:2]
    ref_store, ref_pipe = _pipeline(REF, model, jc)
    port_store, port_pipe = _pipeline(PORT, model, tc, device="cpu")
    n = 0
    for epoch in (0, 1):
        for jb, tb in zip(ref_pipe.batches(epoch), port_pipe.batches(epoch),
                          strict=True):
            for k in ("tokens", "labels"):
                assert tb[k].dtype == torch.int64 and tb[k].device.type == "cpu"
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
            assert torch.equal(tb["labels"], torch.roll(tb["tokens"], -1, 1))
            n += 1
    assert n == 8
    assert events(port_store.fs) == events(ref_store.fs)


def test_train_step_on_the_first_pipeline_batch_matches_the_reference():
    jc, tc, jopt, topt, jstate, tstate = _both_states("starcoder2-3b", 0.0)
    jb = next(_pipeline(REF, "session", jc, seq=16)[1].batches(0))
    tb = next(_pipeline(PORT, "session", tc, seq=16, device="cpu")[1].batches(0))
    jnew, jm = jax.jit(JTS.make_train_step(jc, jopt))(jstate, jb)
    tnew, tm = make_train_step(tc, topt)(tstate, tb)
    jnew = jax.device_get(jnew)
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    for n, p in tnew["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   reference_leaf(jnew["params"], n, tc),
                                   err_msg=n, **TOL)
    assert jb["tokens"].dtype == jnp.int32


# --------------------------------------------------------------------------
# run_workload, run_scr
# --------------------------------------------------------------------------
WORKLOADS = ("cn_w", "sn_w", "cc_r", "cs_r", "rn_r", "rn_r_hot",
             "rn_r_hot_set", "ckpt_w")


def _workload(pkg, name, model, deployment):
    cfg = getattr(pkg["workloads"], name)(2, 4096, model, p=2, m=3)
    fs = pkg["basefs"].BaseFS(**deployment)
    res = pkg["workloads"].run_workload(cfg, fs=fs)
    return fs, res


@pytest.mark.parametrize("deployment", [{}, {"num_shards": 2, "batch": 4}],
                         ids=["default", "sharded-batched"])
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("name", WORKLOADS)
def test_run_workload_matches_the_reference(name, model, deployment):
    ref_fs, want = _workload(REF, name, model, deployment)
    port_fs, got = _workload(PORT, name, model, deployment)
    assert events(port_fs) == events(ref_fs)
    assert len(events(ref_fs)) > 10
    assert fields(got.config) == fields(want.config)
    assert phases(got.phases) == phases(want.phases)
    assert (got.verified_reads, got.rpc_counts) == (want.verified_reads,
                                                     want.rpc_counts)


def _scr(pkg, model, faulty):
    cfg = pkg["scr"].SCRConfig(n=4, model=model, p=2, particles=6000)
    faults = (pkg["faults"].FaultSchedule(
        seed=7, drop_rate=0.2, slow_shards=((0, 1.5),),
        lost_nodes=(cfg.failed_node,), buffer_loss_nodes=(1,))
        if faulty else None)
    tracer = pkg["trace"].ExecutionTracer()
    res = pkg["scr"].run_scr(cfg, tracer=tracer, faults=faults)
    return res, [fields(op) for op in tracer.exe.ops], tracer.exe.so_edges


@pytest.mark.parametrize("faulty", [False, True], ids=["no-faults", "seeded"])
@pytest.mark.parametrize("model", ["commit", "session"])
def test_run_scr_matches_the_reference(model, faulty):
    want, want_ops, want_so = _scr(REF, model, faulty)
    got, got_ops, got_so = _scr(PORT, model, faulty)
    assert (got_ops, got_so) == (want_ops, want_so)
    assert len(want_ops) > 50
    assert phases(got.phases) == phases(want.phases)
    assert fields(got.config) == fields(want.config)
    for attr in ("checkpoint_bytes", "restart_bytes", "rpc_counts",
                 "verified_reads"):
        assert getattr(got, attr) == getattr(want, attr), attr
    retries = sum(p.rpc_retries for p in got.phases)
    assert (retries > 0) == faulty

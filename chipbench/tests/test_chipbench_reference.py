"""The reference against the port at tiny sizes on the CPU.

The port runs here on its plain paths in float32, so the two agree to
float32 rounding; the reference imports nothing of the port, and this
test is where the two meet.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from conftest import tiny_cell

from chipbench import weights as W
from chipbench.kinds import train as TK
from chipbench.reference import decoder as ref
from chipbench.reference import epoch as ref_epoch

CELLS = ["starcoder2-train-2k", "phi35moe-train-4k"]


def _f32_cell(workload):
    cell = tiny_cell(workload, dtype="float32")
    return cell, cell.config["model"]


def _port_model(m, seed):
    from repro_torch.models.transformer import Transformer
    model = Transformer(TK.port_config(m), device="cpu")
    W.load_into(dict(model.named_parameters()), m, seed)
    return model


@pytest.mark.parametrize("workload", CELLS)
def test_prefill_logits_and_cache_match_port(workload):
    cell, m = _f32_cell(workload)
    seed, T = 5, 24
    tokens = W.prompt(seed, 0, 3, T, m["vocab"], "cpu")
    with torch.inference_mode():
        logits, cache = _port_model(m, seed).prefill(tokens, T)
    kv = {}
    want = ref.prefill(m, cell.config["norm_eps"], W.make_weights(m, seed, "cpu"), tokens,
                       lambda i, k, v: kv.__setitem__(i, (k, v)))
    torch.testing.assert_close(logits[:, -1], want, atol=1e-4, rtol=1e-4)
    for i, (k, v) in kv.items():
        torch.testing.assert_close(cache[i]["k"], k, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(cache[i]["v"], v, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("workload", CELLS)
def test_three_train_steps_match_port(workload):
    """Losses, the first gradient as AdamW takes it and the weights after
    three steps of the port's train step against the reference's."""
    cell, m = _f32_cell(workload)
    seed = 11
    s = TK.Session(cell, seed, "cpu")
    first = s.first_steps(3)
    params = {n: p.detach().clone() for n, p in s.state["params"].named_parameters()}
    r = TK.reference_run(cell, seed, torch.device("cpu"))
    np.testing.assert_allclose(first["loss"], r["loss"], rtol=1e-5)
    for n, g in r["grad1"].items():
        assert first["grad1"][n] == pytest.approx(g, rel=1e-4, abs=1e-7), n
    weights = W.make_weights(m, seed, "cpu")
    batches = [torch.from_numpy(b) for b in TK.expected_batches(cell, seed, 3)]
    ref.train(m, cell.config["norm_eps"], weights, batches, cell.traffic["opt"])
    for n, p in params.items():
        torch.testing.assert_close(p, weights[n], atol=2e-6, rtol=1e-4)
    numbers = TK.numbers(first, r)
    assert max(numbers.values()) < 1e-3


def test_epoch_order_matches_store_and_pipeline():
    from repro_torch.data.dlio import PreloadedStore
    from repro_torch.data.pipeline import TokenPipeline
    cell = tiny_cell("starcoder2-train-2k")
    t, m = cell.traffic, cell.config["model"]
    seed = 2 ** 31 + 12345
    n = t["hosts"] * t["samples_per_host"]
    for epoch in range(3):
        flat = [i for sub in PreloadedStore("session", t["hosts"], t["samples_per_host"],
                                            procs_per_host=t["procs_per_host"])
                .epoch_assignment(epoch, seed) for i in sub]
        assert flat == ref_epoch.epoch_order(n, t["hosts"], t["procs_per_host"], seed, epoch)
    samples = W.corpus(seed, n, t["seq"], m["vocab"])
    store = PreloadedStore("session", t["hosts"], t["samples_per_host"],
                           procs_per_host=t["procs_per_host"], samples=list(samples))
    store.preload()
    pipe = TokenPipeline(store, TK.port_config(m), t["batch"], t["seq"], seed=seed, device="cpu")
    got = list(itertools.islice(itertools.chain(pipe.batches(0), pipe.batches(1)), 12))
    want = TK.expected_batches(cell, seed, 12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"].numpy(), w)
        np.testing.assert_array_equal(g["labels"].numpy(), np.roll(w, -1, axis=1))


def test_moe_drops_slots_past_capacity():
    """With a capacity of 8 slots and every token routed to the same two
    experts, slots past the eighth of each expert are dropped, in slot
    order, and only the kept slots reach the output."""
    m = dict(tiny_cell("phi35moe-train-4k").config["model"], moe_capacity=0.01)
    model = ref.Model(m, 1e-6)
    D, E = m["d_model"], m["moe_experts"]
    torch.manual_seed(0)
    x = torch.randn(1, 20, D)
    w = {"router": torch.zeros(D, E)}
    w["router"][:, 1] = 1.0
    w["router"][:, 3] = 0.5
    x = x.abs()
    for n, shape in (("wi", (E, D, m["d_ff"])), ("wg", (E, D, m["d_ff"])),
                     ("wo", (E, m["d_ff"], D))):
        w[n] = torch.randn(shape) * 0.1
    get = lambda n, e=None: (w[n.split("ffn.")[-1]] if e is None  # noqa: E731
                             else w[n.split("ffn.")[-1]][e])
    y, _ = model.moe(get, "layers.0.", x)
    assert model.capacity(20) == 8
    assert torch.count_nonzero(y[0, :8].abs().sum(-1)) == 8
    assert torch.count_nonzero(y[0, 8:].abs().sum(-1)) == 0


def test_fp8_control_moves_the_logits():
    cell, m = _f32_cell("starcoder2-train-2k")
    tokens = W.prompt(3, 0, 2, 16, m["vocab"], "cpu")
    w = W.make_weights(m, 3, "cpu")
    V = m["vocab"]
    exact = ref.prefill(m, 1e-6, w, tokens)[:, :V]
    low = ref.prefill(m, 1e-6, w, tokens, fp8=True)[:, :V]
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.5

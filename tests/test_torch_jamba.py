"""AI21-Jamba2-3B in the port: hybrid Mamba-1 / attention blocks against the
benchmark's plain reference (``chipbench/reference/jamba.py``).

On the CPU at a tiny size with seeded random weights drawn as the benchmark
draws them (``chipbench/weights_hybrid.py``): both mixer kinds, an FFN after
every mixer, the dt/B/C norms, attention without RoPE.  Both sides run in
float32 here, so they agree to float32 rounding of differently ordered sums;
the tolerances below say how far that reaches.  The JAX package has no
Jamba, so the reference is the benchmark's own.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from chipbench import counts_hybrid as CH  # noqa: E402
from chipbench import harness  # noqa: E402
from chipbench import trace_hybrid as TH  # noqa: E402
from chipbench import weights_hybrid as WH  # noqa: E402
from chipbench.reference import jamba as J  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import jamba2_3b  # noqa: E402
from repro_torch.configs.registry import (ARCH_NAMES, ARCHS, PORT_ARCHS,  # noqa: E402
                                          get_config, tiny_config)
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.train_step import loss_fn, make_train_step  # noqa: E402

CELL = "jamba2-3b-train-8k"
EPS = 1e-6
# Two mamba layers around one attention layer, then a fourth (mamba) as the
# pattern's remainder, which the port does not checkpoint.
TINY = dict(n_layers=4, d_model=32, n_heads=4, n_kv_heads=1, d_head=16, d_ff=64,
            vocab=120, pad_vocab_to=64, d_inner=64, ssm_state=4, dt_rank=8,
            dtype="float32", pattern=["mamba", "attn", "mamba"])


def _kind():
    return harness.load_module(ROOT / "chipbench" / "kinds" / "train_hybrid.py",
                               "chipbench_kind_train_hybrid")


def _tiny_cell():
    cell = copy.deepcopy(harness.load_cell(CELL))
    cell.config["model"].update(TINY)
    cell.traffic.update(seq=16, samples_per_host=8)
    return cell


def _model(m: dict, seed: int):
    model = Transformer(_kind().port_config(m), device="cpu")
    WH.load_into(dict(model.named_parameters()), m, seed)
    return model


def _tokens(m, seed, B=2, T=16):
    return WH.prompt(seed, 0, B, T, m["vocab"], "cpu")


def test_registry_resolves_jamba_outside_the_reference_ten():
    assert len(ARCHS) == 10 and "jamba2-3b" not in ARCHS
    assert PORT_ARCHS["jamba2-3b"] is get_config("jamba2-3b") is jamba2_3b.CONFIG
    assert tiny_config("jamba2-3b") is jamba2_3b.TINY and "jamba2-3b" in ARCH_NAMES
    from repro_torch.launch.train import parse_args
    assert parse_args(["--arch", "jamba2-3b"]).arch == "jamba2-3b"
    cfg = get_config("jamba2-3b")
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [7, 21]
    assert cfg.inner == 2 * cfg.d_model and cfg.head_dim == 128 and cfg.n_super == 2


@pytest.mark.parametrize("which", ["CONFIG", "TINY"])
def test_params_total_counts_every_leaf(which):
    """``params_total`` is the leaf count of the model on meta, the padded
    vocabulary rows (embedding and head) left out; with the FFN and the
    dt/B/C norms of each mamba block."""
    cfg = getattr(jamba2_3b, which)
    model = Transformer(cfg, device="meta")
    held = sum(p.numel() for p in model.parameters())
    assert cfg.params_total() == held - 2 * (cfg.vocab_padded - cfg.vocab) * cfg.d_model
    plain = dataclasses.replace(cfg, mamba_ffn=False, mamba_dt_bc_norm=False)
    n_mamba = sum(cfg.pattern[i % len(cfg.pattern)] == "mamba" for i in range(cfg.n_layers))
    D, F, R, N = cfg.d_model, cfg.d_ff, cfg.dtrank, cfg.ssm_state
    assert cfg.params_total() - plain.params_total() == n_mamba * (D + 3 * D * F + R + 2 * N)
    if which == "CONFIG":
        assert cfg.params_total() == 3_197_109_632


def test_full_width_leaves_are_the_benchmarks():
    """The port's parameters at full width, on meta, have exactly the names,
    shapes and dtypes that ``weights_hybrid`` draws for the configuration
    file, and the file's ``params_total``."""
    conf = json.loads((ROOT / "chipbench" / "configs" / "jamba2-3b.json").read_text())
    m = conf["model"]
    model = Transformer(_kind().port_config(m), device="meta")
    got = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    want = {s.name: (s.shape, s.dtype) for s in WH.param_specs(m)}
    assert got == want
    assert sum(math.prod(s) for s, _ in want.values()) == conf["params_total"]
    assert dataclasses.asdict(_kind().port_config(m)) == dataclasses.asdict(jamba2_3b.CONFIG)


def test_weights_draw_mambas_published_init():
    m = dict(harness.load_cell(CELL).config["model"], **TINY)
    w = WH.make_weights(m, 2 ** 31 + 5, "cpu")
    A_log = w["layers.0.mixer.A_log"]
    assert torch.equal(A_log, torch.log(torch.arange(1.0, 5.0)).expand(64, 4))
    dt = torch.nn.functional.softplus(w["layers.0.mixer.dt_bias"])
    assert float(dt.min()) >= WH.DT_MIN * (1 - 1e-5) and float(dt.max()) <= WH.DT_MAX * (1 + 1e-5)
    assert float(dt.log().std()) > 0.5          # spread over the two decades, not one value
    assert float(w["layers.0.mixer.conv_b"].abs().max()) <= 0.5
    assert torch.equal(w["layers.2.mixer.in_proj"], WH.make_weights(m, 2 ** 31 + 5, "cpu")[
        "layers.2.mixer.in_proj"])


@pytest.mark.parametrize("shape", [(2, 37, 20, 4), (1, 64, 7, 3), (1, 5, 3, 16), (3, 16, 9, 1)])
def test_chunked_scan_matches_the_sequential_recurrence(shape):
    """The reference's chunked scan against the recurrence one step at a
    time, values and every input's gradient, in float64 so that only the
    order of the sums differs (1e-10); T not a multiple of the chunk, channel
    blocks that do not divide I, and the cell's own chunk and blocks."""
    Bt, T, I, N = shape
    g = torch.Generator().manual_seed(sum(shape))
    u = torch.randn(Bt, T, I, generator=g, dtype=torch.float64)
    delta = torch.rand(Bt, T, I, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(I, N, generator=g, dtype=torch.float64) * 8
    B = torch.randn(Bt, T, N, generator=g, dtype=torch.float64)
    C = torch.randn(Bt, T, N, generator=g, dtype=torch.float64)
    outs = []
    for fn in (lambda *a: J.scan(*a, L=8, channels=4), J.scan_sequential, J.scan):
        ins = [t.clone().requires_grad_(True) for t in (u, delta, A, B, C)]
        y = fn(*ins)
        outs.append((y, torch.autograd.grad((y * y.detach().cos()).sum(), ins)))
    (y2, g2) = outs[1]
    for y1, g1 in (outs[0], outs[2]):
        torch.testing.assert_close(y1, y2, atol=1e-10, rtol=1e-10)
        for a, b in zip(g1, g2):
            torch.testing.assert_close(a, b, atol=1e-10, rtol=1e-10)


def test_port_logits_loss_grads_and_adamw_step_match_reference():
    """At TINY in float32: the port's logits, loss, every leaf's gradient
    and one AdamW step against the reference's.  Logits and loss 1e-5
    relative (float32 rounding of differently ordered sums over at most
    a few hundred terms); gradients 1e-4 of each leaf's own norm (they pass
    back through the scan's recurrence and four layers, each side summing in
    its own order); the step's weights 1e-5, which is where float32 leaves
    the update's last digits."""
    cell = _tiny_cell()
    m, seed = cell.config["model"], 2 ** 31 + 21
    tokens = _tokens(m, seed)
    model = _model(m, seed)
    model.requires_grad_(True)
    labels = torch.roll(tokens, -1, dims=1)
    with torch.no_grad():
        logits, _ = model(tokens)
    want = J.forward(m, EPS, WH.make_weights(m, seed, "cpu"), tokens)
    torch.testing.assert_close(logits, want, atol=1e-5, rtol=1e-5)

    cfg = model.cfg
    loss, _ = loss_fn(model, {"tokens": tokens, "labels": labels}, cfg)
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    weights = WH.make_weights(m, seed, "cpu")
    ref_grads = {n: torch.zeros_like(w) for n, w in weights.items()}
    ref_loss = J.loss_and_grads(J.Jamba(m, EPS), weights, tokens, ref_grads)
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    assert grads.keys() == ref_grads.keys()
    for n, g in grads.items():
        err = float((g - ref_grads[n]).norm() / ref_grads[n].norm().clamp(min=1e-12))
        assert err < 1e-4, (n, err)

    opt = AdamWConfig(**cell.traffic["opt"], state_dtype=torch.float32)
    model = _model(m, seed)
    model.requires_grad_(True)
    state = {"params": model, "opt": adamw_init(dict(model.named_parameters()), opt),
             "step": torch.zeros((), dtype=torch.int32)}
    state, _ = make_train_step(cfg, opt)(state, {"tokens": tokens, "labels": labels})
    weights = WH.make_weights(m, seed, "cpu")
    J.train(m, EPS, weights, [tokens], cell.traffic["opt"])
    for n, p in state["params"].named_parameters():
        torch.testing.assert_close(p, weights[n], atol=1e-5, rtol=1e-5, msg=n)


def test_prefill_then_decode_through_the_hybrid_cache_matches_reference():
    """Prefill of 12 tokens, then 4 decode steps through the cache (a mamba
    state and a conv window beside each attention layer's K/V, in one
    list), against the reference's full forward over all 16 positions:
    every step's logits to 1e-5 (float32 rounding; the decode step sums the
    recurrence in another order than the reference's chunks)."""
    m, seed = dict(harness.load_cell(CELL).config["model"], **TINY), 2 ** 31 + 33
    tokens = _tokens(m, seed, B=3, T=16)
    model = _model(m, seed)
    want = J.forward(m, EPS, WH.make_weights(m, seed, "cpu"), tokens)
    with torch.inference_mode():
        logits, cache = model.prefill(tokens[:, :12], 16)
        assert [sorted(c) for c in cache] == [["conv", "h"], ["k", "v"], ["conv", "h"],
                                              ["conv", "h"]]
        torch.testing.assert_close(logits[:, -1], want[:, 11], atol=1e-5, rtol=1e-5)
        for t in range(12, 16):
            logits, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
            torch.testing.assert_close(logits[:, 0], want[:, t], atol=1e-5, rtol=1e-5)


def test_attention_takes_no_rope_and_the_dt_bc_norms_count():
    """With RoPE on (``use_rope=True``) the port leaves the reference, which
    has none, as it does with the B norm's scale doubled: both are
    more than float32 rounding (1e-3 against the 1e-5 they agree to)."""
    m, seed = dict(harness.load_cell(CELL).config["model"], **TINY), 2 ** 31 + 8
    tokens = _tokens(m, seed)
    want = J.forward(m, EPS, WH.make_weights(m, seed, "cpu"), tokens)
    with torch.no_grad():
        roped, _ = _model(dict(m, use_rope=True), seed)(tokens)
        model = _model(m, seed)
        for blk in model.layers:
            if blk.btype == "mamba":
                blk.mixer["b_norm"].mul_(2.0)
        moved, _ = model(tokens)
    assert float((roped - want).abs().max()) > 1e-3
    assert float((moved - want).abs().max()) > 1e-3


def test_fp8_control_moves_the_logits():
    """The control (float8 products) lands well away from the reference but
    still near it: what the cell's limits sit between."""
    m, seed = dict(harness.load_cell(CELL).config["model"], **TINY), 3
    tokens = _tokens(m, seed)
    w = WH.make_weights(m, seed, "cpu")
    exact = J.forward(m, EPS, w, tokens)[..., :m["vocab"]]
    low = J.forward(m, EPS, w, tokens, fp8=True)[..., :m["vocab"]]
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.5


def test_hybrid_cell_check_passes_on_the_cpu():
    """The cell's kind, as the benchmark runs it, on the CPU at TINY in
    float32: the fed batches are the store's epoch order, and the port's
    first three steps agree with the reference's far inside every limit
    (float32 on both sides: 1e-5)."""
    cell = _tiny_cell()
    K = _kind()
    assert K.base.W is WH and K.base.counts is CH and K.base.tr is TH
    out = K.run(cell, 2 ** 31 + 77, 0.5, False, start=time.perf_counter(), device="cpu")
    values = {c.name: c.value for c in out.checks}
    assert values.keys() == {"ingest_bad_batches", "loss1_rel_gap", "grad1_leaf_gap",
                             "change_leaf_gap"}
    assert values["ingest_bad_batches"] == 0
    assert max(values.values()) < 1e-5
    assert out.attempted >= 1 and out.failed == 0
    m = cell.config["model"]
    assert out.readings["model_flops"] == out.attempted * CH.train_step_flops(m, 2, 16)


def test_mamba_mix_span_in_forward_and_backward():
    """Under a CPU profiler each mamba layer's mixer opens
    ``repro_torch.mamba.mix`` once in the forward and once in the backward
    (remat off), the backward's inside the port's backward phase; the spans
    change no number."""
    m = dict(harness.load_cell(CELL).config["model"], **TINY, remat=False)
    cfg = _kind().port_config(m)
    seed = 2 ** 31 + 9
    opt = AdamWConfig()

    def state():
        model = _model(m, seed)
        model.requires_grad_(True)
        return {"params": model, "opt": adamw_init(dict(model.named_parameters()), opt),
                "step": torch.zeros((), dtype=torch.int32)}

    tokens = _tokens(m, seed, B=2, T=16)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    step = make_train_step(cfg, opt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced, metrics = step(state(), batch)
    plain, plain_metrics = step(state(), batch)
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events() if e.name().startswith(obs.PREFIX))
    phase = {n: (s, e) for s, e, n in spans if n in (obs.FORWARD, obs.BACKWARD)}
    mix = [(s, e) for s, e, n in spans if n == obs.MAMBA_MIX]
    n_mamba = sum(b.btype == "mamba" for b in traced["params"].layers)
    inside = lambda p: [x for x in mix if phase[p][0] <= x[0] and x[1] <= phase[p][1]]  # noqa: E731
    assert n_mamba == 3 and len(inside(obs.FORWARD)) == 3 and len(inside(obs.BACKWARD)) == 3
    assert torch.equal(metrics["loss"], plain_metrics["loss"])
    for (n, a), (_, b) in zip(traced["params"].named_parameters(),
                              plain["params"].named_parameters()):
        assert torch.equal(a, b), n


def test_scan_scope_counts_each_call_and_its_backward():
    """The benchmark's scan scope wraps the port's scan entry: a forward and
    a backward of TINY count one call each a mamba layer, with the bound
    of ``counts_hybrid``, and leave the step's numbers as they are."""
    m, seed = dict(harness.load_cell(CELL).config["model"], **TINY), 2 ** 31 + 4
    tokens = _tokens(m, seed, B=2, T=16)
    model = _model(m, seed)
    model.requires_grad_(True)
    cfg = model.cfg
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    plain = torch.autograd.grad(loss_fn(model, batch, cfg)[0], list(model.parameters()))
    scope = TH.ScanScope()
    try:
        got = torch.autograd.grad(loss_fn(model, batch, cfg)[0], list(model.parameters()))
    finally:
        scope.close()
    from repro_torch.kernels import ops
    assert ops.ssm_scan is scope.orig
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    sizes = {"x": 4, "dt": 4, "B": 4, "C": 4}
    one = (CH.bound_s(*CH.scan_fwd(2, 16, 64, 4, sizes))
           + CH.bound_s(*CH.scan_bwd(2, 16, 64, 4, sizes)))
    # 3 mamba layers, the two in the super-block recomputed under remat.
    assert scope.calls == 3 * 2 + 2
    assert scope.bound_s == pytest.approx(3 * one + 2 * CH.bound_s(*CH.scan_fwd(2, 16, 64, 4, sizes)))


def test_counts_hybrid_against_hand_worked_numbers():
    """A 3-layer (mamba, attn, mamba) model, D=4, I=8, R=2, N=2, 2 query
    heads over 1 KV head of dim 2, F=6, V=10, one sequence of 3:
    mamba 2*3*(4*16 + 8*6 + 2*8 + 8*4) = 960 each; attention
    2*3*4*4*2 + 2*3*2*2*4 + 4*2*1*2*6 pairs = 384; FFN 6*3*4*6 = 432 each;
    head 2*3*4*10 = 240; a step 3 * (2*960 + 384 + 3*432 + 240) = 11520.
    The scan over (2, 3, 4, 2), x, B, C bf16 and dt f32: forward 24*(12+3)
    = 360 operations, 48 exps, 24*(2*2+4) + 6*2*(2+2) + 4*(8+4+16) = 352
    bytes; backward 48*20 = 960 operations, 48 exps, 24*(3*2+2*4) +
    2*6*2*(2+2) + 8*(8+4) = 528 bytes.  At the cell's size a step is
    301.6 TFLOP, the mamba mixers' products 34.8% of it, the FFNs 57.4%,
    attention 2.3%."""
    m = dict(pattern=["mamba", "attn"], n_layers=3, d_model=4, d_inner=8, dt_rank=2,
             ssm_state=2, n_heads=2, n_kv_heads=1, d_head=2, d_ff=6, vocab=10)
    assert CH.train_step_flops(m, 1, 3) == 11520
    sizes = {"x": 2, "dt": 4, "B": 2, "C": 2}
    assert CH.scan_fwd(2, 3, 4, 2, sizes) == (360, 48, 352)
    assert CH.scan_bwd(2, 3, 4, 2, sizes) == (960, 48, 528)
    assert CH.bound_s(67e12, 0, 0) == pytest.approx(1.0)
    assert CH.bound_s(0, CH.PEAK_SPECIAL, 0) == pytest.approx(1.0)
    assert CH.PEAK_SPECIAL == pytest.approx(4.18e12, rel=1e-3)
    full = harness.load_cell(CELL).config["model"]
    step = CH.train_step_flops(full, 2, 8192)
    assert step == 301_603_844_259_840
    mix = 3 * 26 * CH._mamba_forward(full, 2, 8192)
    assert mix / step == pytest.approx(0.3485, abs=1e-4)
    assert 3 * 2 * CH._attn_forward(full, 2, 8192) / step == pytest.approx(0.0226, abs=1e-4)


class _Ev(SimpleNamespace):
    def name(self): return self.n
    def start_ns(self): return self.s
    def duration_ns(self): return self.d
    def start_thread_id(self): return self.t
    def correlation_id(self): return self.c
    def is_user_annotation(self): return self.note

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.dev else torch.autograd.DeviceType.CPU


def _note(n, s, e, t=1):
    return _Ev(n=n, s=s, d=e - s, t=t, c=0, dev=False, note=True)


def _kernel(c, launch, start, dur, t=1):
    return [_Ev(n="cudaLaunchKernel", s=launch, d=5, t=t, c=c, dev=False, note=False),
            _Ev(n=f"k{c}", s=start, d=dur, t=0, c=c, dev=True, note=False)]


def test_trace_reads_the_scan_and_the_mixers_time(monkeypatch):
    """A synthetic traced window: kernels launched in a scan span (forward on
    the caller's thread, backward on autograd's) count as the scan's; those
    launched while ``repro_torch.mamba.mix`` is open on the launching thread
    count as the mixers', the scan's among them; a launch on another thread
    at the same time does not."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    events = [_note("chipbench.window", 0, 10_000), _note("chipbench.step", 100, 9000),
              _note(TH.MAMBA_MIX, 1000, 2000), _note(TH.SCAN_FWD, 1200, 1500),
              _note(TH.MAMBA_MIX, 5000, 6000, t=2), _note(TH.SCAN_BWD, 5100, 5400, t=2),
              *_kernel(1, 1100, 1100, 100),          # mixer, forward
              *_kernel(2, 1300, 1300, 200),          # scan forward, in the mixer
              *_kernel(3, 5200, 5200, 300, t=2),     # scan backward, in the mixer
              *_kernel(4, 5500, 5600, 50, t=2),      # mixer backward
              *_kernel(5, 5600, 5700, 70, t=1),      # another thread at that time
              *_kernel(6, 3000, 3000, 400)]          # outside both
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)), __exit__=lambda *a: None)
    prof.__exit__ = lambda *a: None
    scope = SimpleNamespace(flash=None, scan=SimpleNamespace(bound_s=2.5e-7, calls=2))
    r = TH.finish(prof, scope)
    assert round(r["scan_device_s"] * 1e9) == 500
    assert round(r["mamba_mix_s"] * 1e9) == 100 + 200 + 300 + 50
    assert r["scan_calls"] == 2 and r["scan_bound_s"] == 2.5e-7
    rd = {"kind": "train", "steps": 2, "trace": r}
    metric = lambda n: harness.load_module(ROOT / "chipbench" / "metrics" / f"{n}.py",  # noqa: E731
                                           "m_" + n.replace(".", "_")).read
    assert metric("ssm_scan_roofline.train")(rd) == pytest.approx(50.0)
    assert metric("mamba_mix_ms.train")(rd) == pytest.approx(650e-9 * 1e3 / 2)
    assert metric("mamba_mix_ms.train")({"kind": "train", "steps": 2, "trace": {}}) is None
    # The port's own reader puts a launch with no port span open on its
    # thread down to one open on any thread, so it counts kernel 5 too.
    assert obs.split(events)["span_launches"][obs.MAMBA_MIX] == 5


def test_reference_and_benchmark_modules_load_no_jax_or_port():
    """The reference, the hybrid weights and counts import nothing of JAX,
    of ``repro`` or of ``repro_torch``."""
    code = ("import sys\n"
            "import chipbench.reference.jamba, chipbench.weights_hybrid, chipbench.counts_hybrid\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'repro_torch'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_reference_train_is_the_decoders_on_a_plain_stack(monkeypatch):
    """With no mamba layer (pattern ``attn`` only) the hybrid reference's
    training is the decoder reference's, two implementations written
    apart, with the decoder's RoPE taken out: losses to 1e-6 and the
    updated weights to 1e-5 (float32 rounding of differently batched
    products)."""
    from chipbench.reference import decoder as D
    monkeypatch.setattr(D.Model, "rope", lambda self, x: x)
    m = dict(harness.load_cell(CELL).config["model"], **TINY)
    m["pattern"] = ["attn"]
    seed, opt = 4, harness.load_cell(CELL).traffic["opt"]
    batches = [_tokens(m, seed, B=2, T=12), _tokens(m, seed + 1, B=2, T=12)]
    w1, w2 = WH.make_weights(m, seed, "cpu"), WH.make_weights(m, seed, "cpu")
    a = J.train(m, EPS, w1, batches, opt)
    b = D.train(m, EPS, w2, batches, opt)
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
    for n in w1:
        torch.testing.assert_close(w1[n], w2[n], atol=1e-6, rtol=1e-5)

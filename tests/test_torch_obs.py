"""The port's spans (``repro_torch.obs``) and the readings of a trace.

Under a CPU ``torch.profiler`` a train step records its three phases in
turn, a MoE step its dispatch in the forward and the backward; without a
profiler no ``record_function`` is entered.  :func:`obs.split` and the
benchmark's ``chipbench.trace.finish`` are run on synthetic kineto-like
events.  The ``gpu`` case reads a traced step on the card."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs.registry import tiny_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.serve.decode import make_prefill
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step, train_state_init

ROOT = Path(__file__).resolve().parents[1]


def _step(arch: str, M: int = 1, device="cpu", **over):
    cfg = dataclasses.replace(tiny_config(arch), **over)
    opt = AdamWConfig()
    state = train_state_init(torch.Generator(device=device).manual_seed(0), cfg, opt, device)
    batch = synthetic_batch(1, cfg, 4, 16, device)
    return make_train_step(cfg, opt, num_microbatches=M), state, batch


def _ours(prof) -> List[tuple]:
    """(start, end, name) of the port's spans, in order of their starts."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(obs.PREFIX))


@pytest.mark.parametrize("M", [1, 2])
def test_train_step_records_its_phases_in_turn(M):
    step, state, batch = _step("starcoder2-3b", M)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    phases = [s for s in _ours(prof) if s[2].startswith(obs.PHASE)]
    assert [n for _, _, n in phases] == [obs.FORWARD, obs.BACKWARD] * M + [obs.OPTIMIZER]
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))


def test_moe_step_records_dispatch_in_forward_and_backward():
    """Without remat every dispatch span inside the backward is the
    backward's own (opened and closed by the identity nodes); the spans
    change no number of the step."""
    step, state, batch = _step("granite-moe-1b-a400m", remat=False)
    _, plain_state, _ = _step("granite-moe-1b-a400m", remat=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced, metrics = step(state, batch)
    plain, plain_metrics = step(plain_state, batch)
    spans = _ours(prof)
    inside = {p: [s for s in spans if s[2] == obs.MOE_DISPATCH and p[0] <= s[0] and s[1] <= p[1]]
              for p in spans if p[2] in (obs.FORWARD, obs.BACKWARD)}
    by_phase = {p[2]: len(v) for p, v in inside.items()}
    assert by_phase[obs.FORWARD] >= 2 and by_phase[obs.BACKWARD] >= 2
    assert torch.equal(metrics["loss"], plain_metrics["loss"])
    for (n, a), (_, b) in zip(traced["params"].named_parameters(),
                              plain["params"].named_parameters()):
        assert torch.equal(a, b), n


def test_spans_off_enter_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert obs.span(obs.FORWARD) is obs.span(obs.OPTIMIZER)
    with obs.span(obs.FORWARD):
        pass
    step, state, batch = _step("granite-moe-1b-a400m")
    step(state, batch)
    with torch.inference_mode():
        make_prefill(state["params"], 16)(batch["tokens"])


class Ev:
    """A kineto event as ``chipbench.trace.finish`` and ``obs.split`` read it."""

    def __init__(self, name, start, dur, thread=1, corr=0, device=False, note=False):
        self._n, self._s, self._d, self._t, self._c = name, start, dur, thread, corr
        self._dev, self._note = device, note

    def name(self): return self._n
    def start_ns(self): return self._s
    def duration_ns(self): return self._d
    def start_thread_id(self): return self._t
    def correlation_id(self): return self._c
    def is_user_annotation(self): return self._note

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU


def note(name, start, end, thread=1):
    return Ev(name, start, end - start, thread, note=True)


def kernel(corr, launch_at, start, dur, thread=1, name="k"):
    """A launch call on ``thread`` and the device operation it started."""
    return [Ev("cudaLaunchKernel", launch_at, 5, thread, corr),
            Ev(f"{name}{corr}", start, dur, corr=corr, device=True)]


def test_split_puts_each_operation_down_to_its_phase_and_innermost_span():
    events = [note(obs.FORWARD, 0, 1000), note(obs.MOE_DISPATCH, 100, 300),
              note(obs.BACKWARD, 1000, 3000), note(obs.OPTIMIZER, 3000, 4000),
              note(obs.MOE_DISPATCH, 1500, 2000, thread=2),
              note(obs.INGEST_TO_DEVICE, 4100, 4200),
              *kernel(1, 50, 60, 100),              # forward
              *kernel(2, 150, 200, 100),            # forward, in the dispatch
              *kernel(3, 1600, 1700, 200, 2),       # autograd's thread, in its dispatch span
              *kernel(4, 2500, 2600, 300, 2),       # autograd's thread, no span of its own
              *kernel(5, 3100, 3200, 400),          # optimizer
              *kernel(6, 4150, 4300, 100)]          # ingest, outside the phases
    r = obs.split(events)
    ms = lambda d: {k: round(v * 1e9) for k, v in d.items()}  # noqa: E731
    assert ms(r["phase_s"]) == {obs.FORWARD: 200, obs.BACKWARD: 500, obs.OPTIMIZER: 400,
                                "none": 100}
    assert ms(r["span_s"]) == {obs.FORWARD: 100, obs.MOE_DISPATCH: 300, obs.BACKWARD: 300,
                               obs.OPTIMIZER: 400, obs.INGEST_TO_DEVICE: 100}
    assert r["span_launches"][obs.MOE_DISPATCH] == 2
    assert round(r["busy_s"] * 1e9) == 1200 and round(r["window_s"] * 1e9) == 4340
    assert ms(r["idle_by_span"]) == {obs.MOE_DISPATCH: 40 + 700, obs.FORWARD: 1400,
                                     obs.BACKWARD: 300, obs.OPTIMIZER: 700}


def _window_trace(with_ours: bool) -> list:
    """A traced train window: the benchmark's spans, autograd's thread in
    the flash backward, and (optionally) the port's spans inside them."""
    ev = [note("chipbench.window", 0, 10_000),
          note("chipbench.ingest", 10, 1000), note("chipbench.step", 1000, 9000),
          note("chipbench.loss_read", 9000, 10_000),
          note("chipbench.flash_fwd", 1500, 1800), note("chipbench.flash_bwd", 4000, 4500, 2),
          Ev("aten::copy_", 500, 300), Ev("aten::mul", 7000, 200),
          *kernel(1, 600, 700, 200), *kernel(2, 1600, 1700, 300),
          *kernel(3, 2500, 2600, 500), *kernel(4, 4100, 4200, 600, 2),
          *kernel(5, 5500, 5600, 400, 2), *kernel(6, 7100, 7200, 300),
          *kernel(7, 8100, 8200, 500), *kernel(8, 9100, 9200, 100)]
    if with_ours:
        ev += [note(obs.INGEST_TO_DEVICE, 450, 900), note(obs.FORWARD, 1100, 3000),
               note(obs.MOE_DISPATCH, 2400, 2900), note(obs.BACKWARD, 3000, 6500),
               note(obs.MOE_DISPATCH, 5400, 5900, 2), note(obs.OPTIMIZER, 6500, 8800)]
    return ev


class FakeProf:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events": lambda _: events})()

    def __exit__(self, *a):
        pass


def test_finish_reads_the_same_with_the_ports_spans(monkeypatch):
    """The benchmark's readings of a window are the same whether the port's
    spans are in its trace or not, every number and the kernels' list; its
    idle gaps, labelled by the host op or span open as each starts, name a
    port's span where no op is open inside it."""
    monkeypatch.syspath_prepend(str(ROOT))
    from chipbench import trace as tr
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    before = tr.finish(FakeProf(_window_trace(False)), None)
    after = tr.finish(FakeProf(_window_trace(True)), None)
    assert {k: v for k, v in before.items() if k != "breakdown"} == \
        {k: v for k, v in after.items() if k != "breakdown"}
    assert before["breakdown"]["device_ops"] == after["breakdown"]["device_ops"]
    idle = lambda r: sum(v for _, v in r["breakdown"]["idle_gaps"])  # noqa: E731
    assert idle(before) == pytest.approx(idle(after))
    assert dict(after["breakdown"]["idle_gaps"])["host: " + obs.OPTIMIZER] > 0
    r = obs.split(_window_trace(True), (0, 10_000))
    assert round(r["busy_s"] * 1e9) == round(after["busy_s"] * 1e9)
    assert {k: round(v * 1e9) for k, v in r["phase_s"].items()} == {
        obs.FORWARD: 800, obs.BACKWARD: 1000, obs.OPTIMIZER: 800, "none": 300}
    assert {k: round(v * 1e9) for k, v in r["idle_by_span"].items()} == {
        "chipbench.window": 700, "chipbench.ingest": 800, obs.FORWARD: 600,
        obs.BACKWARD: 1100 + 800 + 1200, obs.OPTIMIZER: 700 + 500, "chipbench.loss_read": 700}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["starcoder2-3b", "granite-moe-1b-a400m"])
def test_traced_step_phases_cover_the_device_time(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    step, state, batch = _step(arch, device="cuda")
    state, m = step(state, batch)
    float(m["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    r = obs.split(prof.profiler.kineto_results.events())
    total = sum(r["phase_s"].values())
    phases = sum(r["phase_s"].get(p, 0.0) for p in (obs.FORWARD, obs.BACKWARD, obs.OPTIMIZER))
    assert total > 0 and phases >= 0.98 * total, r["phase_s"]
    assert all(r["phase_s"].get(p, 0.0) > 0 for p in (obs.FORWARD, obs.BACKWARD, obs.OPTIMIZER))

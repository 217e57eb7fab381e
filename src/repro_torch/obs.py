"""The port's spans: ``torch.profiler`` user annotations at its layer
boundaries, each named ``repro_torch.<layer>.<what>``.

A span is recorded only while a profiler records: ``torch.profiler``
sets ``torch.autograd.profiler._is_profiler_enabled`` on entering and
clears it on leaving.  Otherwise :func:`span` hands back one shared no-op
context and :func:`region` calls its function as it is, so the hot path pays
one attribute read a span.  The spans are ``record_function`` annotations,
which kineto records on the clock of the device operations it traces; a
reader of the trace puts each operation down to the spans open at its
launch (:func:`split`).

* ``repro_torch.train.forward`` / ``.backward`` / ``.optimizer``
  (``train.train_step``): the step's phases, in turn on the calling thread,
  one forward and one backward a microbatch.  Autograd launches the
  backward's device work from a thread of its own while the caller sits in
  ``.backward``, so a phase is the one open at a launch on any thread.
* ``repro_torch.moe.dispatch`` (``models.moe``): routing, the scatter into
  the experts' slab and the combine, forward and (through :func:`region`)
  backward.
* ``repro_torch.mamba.mix`` (``models.ssm``): a mamba block's mixer over a
  whole sequence (projections, conv, the scan, the gate), forward,
  recompute and (through :func:`region`) backward; not the decode step.
* ``repro_torch.ingest.read`` / ``.to_device`` (``data.pipeline``): one
  batch's sample reads through the store, and its copy to the device.
* ``repro_torch.serve.prefill`` (``serve.decode``): one batch's prefill up
  to its first-token argmax.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."
PHASE = PREFIX + "train."
FORWARD, BACKWARD, OPTIMIZER = PHASE + "forward", PHASE + "backward", PHASE + "optimizer"
MOE_DISPATCH = PREFIX + "moe.dispatch"
MAMBA_MIX = PREFIX + "mamba.mix"
INGEST_READ, INGEST_TO_DEVICE = PREFIX + "ingest.read", PREFIX + "ingest.to_device"
PREFILL = PREFIX + "serve.prefill"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` while a profiler records, else a shared
    no-op context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


class _Open(torch.autograd.Function):
    """Identity on a region's outputs; its backward opens the span."""

    @staticmethod
    def forward(ctx, held, name, *xs):
        ctx.held, ctx.name = held, name
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        rf = _profiler.record_function(ctx.name)
        rf.__enter__()
        ctx.held.append(rf)
        return (None, None) + gs


class _Close(torch.autograd.Function):
    """Identity on a region's inputs; its backward closes the span."""

    @staticmethod
    def forward(ctx, held, *xs):
        ctx.held = held
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.held:
            ctx.held.pop().__exit__(None, None, None)
        return (None,) + gs


def _grad_tensors(xs) -> List[int]:
    return [i for i, x in enumerate(xs) if isinstance(x, torch.Tensor) and x.requires_grad]


def _through(fn, xs: list, at: List[int], *first) -> list:
    if at:
        for i, t in zip(at, fn(*first, *(xs[i] for i in at))):
            xs[i] = t
    return xs


def region(name: str, fn: Callable, *args):
    """``fn(*args)`` inside span ``name``; under autograd its backward runs
    inside a span of the same name too, opened by an identity node on the
    result's tensors that require grad (``fn`` returns a tensor or a tuple)
    and closed by one on those of ``args``."""
    if not _profiler._is_profiler_enabled:
        return fn(*args)
    with _profiler.record_function(name):
        at = _grad_tensors(args)
        if not (at and torch.is_grad_enabled()):
            return fn(*args)
        held: list = []
        out = fn(*_through(_Close.apply, list(args), at, held))
        outs = list(out) if isinstance(out, tuple) else [out]
        outs = _through(_Open.apply, outs, _grad_tensors(outs), held, name)
        return tuple(outs) if isinstance(out, tuple) else outs[0]


# -- reading a trace ----------------------------------------------------------
Spans = List[Tuple[int, int, str]]   # (start ns, end ns, name)


class _Timeline:
    """Which of a set of spans is the latest-started one still open at t."""

    def __init__(self, spans: Spans):
        spans = [x for x in spans if x[1] > x[0]]
        points = sorted([(e, 0, s, n) for s, e, n in spans]
                        + [(s, 1, s, n) for s, e, n in spans])
        open_: List[Tuple[int, str]] = []
        self.times: List[int] = []
        self.names: List[Optional[str]] = []
        for t, starts, s, n in points:
            if starts:
                bisect.insort(open_, (s, n))
            else:
                open_.remove((s, n))
            top = open_[-1][1] if open_ else None
            if self.times and self.times[-1] == t:
                self.names[-1] = top
            else:
                self.times.append(t)
                self.names.append(top)

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.times, t) - 1
        return self.names[i] if i >= 0 else None


def split(events, window: Optional[Tuple[int, int]] = None) -> dict:
    """The device's time in a profiler's trace by the port's spans.

    ``events``: ``prof.profiler.kineto_results.events()`` of a finished
    ``torch.profiler.profile``; ``window`` (start, end) in ns, by default
    from the first device operation's start to the last one's end.  Each
    device operation's correlation id names the runtime call that launched
    it; at that call's start its phase is the ``repro_torch.train.*`` span
    open on any thread, and its span the latest-started ``repro_torch.*``
    one open on the launching thread, else on any thread.  Returns, in
    seconds (operations counted whole, busy time clipped to the window):

    * ``phase_s``: by phase, ``"none"`` outside every phase;
    * ``span_s`` and ``span_launches``: time and operations by span;
    * ``busy_s``, ``window_s``: the union of the operations' intervals, and
      the window;
    * ``idle_by_span``: each gap between them by the latest-started user
      annotation open at its start on any thread (the port's or a
      caller's), or ``"outside any span"``.
    """
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type() == cuda and not e.is_user_annotation()]
    host = [e for e in events if e.device_type() != cuda]
    notes = [e for e in host if e.is_user_annotation()]
    launches = {e.correlation_id(): e for e in host
                if not e.is_user_annotation() and e.name().startswith("cu")}

    def spans(es) -> Spans:
        return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in es]

    ours = [e for e in notes if e.name().startswith(PREFIX)]
    phases = _Timeline(spans(e for e in ours if e.name().startswith(PHASE)))
    threads: Dict[int, list] = defaultdict(list)
    for e in ours:
        threads[e.start_thread_id()].append(e)
    on_thread = {t: _Timeline(spans(es)) for t, es in threads.items()}
    anywhere = _Timeline(spans(ours))
    annotated = _Timeline(spans(notes))

    if window is None and device:
        window = (min(e.start_ns() for e in device),
                  max(e.start_ns() + e.duration_ns() for e in device))
    w0, w1 = window or (0, 0)
    phase_s: Dict[str, float] = defaultdict(float)
    span_s: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    iv = []
    for e in device:
        s, d = e.start_ns(), e.duration_ns()
        if s + d <= w0 or s >= w1:
            continue
        iv.append((max(s, w0), min(s + d, w1)))
        phase = where = None
        launch = launches.get(e.correlation_id())
        if launch is not None:
            t, th = launch.start_ns(), launch.start_thread_id()
            phase = phases.at(t)
            where = (on_thread[th].at(t) if th in on_thread else None) or anywhere.at(t)
        phase_s[phase or "none"] += d / 1e9
        span_s[where or "none"] += d / 1e9
        count[where or "none"] += 1
    busy: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if busy and s <= busy[-1][1]:
            busy[-1] = (busy[-1][0], max(busy[-1][1], e))
        else:
            busy.append((s, e))
    idle: Dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip([(w0, w0)] + busy, busy + [(w1, w1)]):
        if b > a:
            idle[annotated.at(a) or "outside any span"] += (b - a) / 1e9
    return {"phase_s": dict(phase_s), "span_s": dict(span_s),
            "span_launches": dict(count),
            "busy_s": sum(e - s for s, e in busy) / 1e9, "window_s": (w1 - w0) / 1e9,
            "idle_by_span": dict(idle)}

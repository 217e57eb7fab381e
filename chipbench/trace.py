"""The benchmark's own spans and its reading of the profiler's trace.

Spans are ``torch.profiler.record_function`` scopes that the benchmark
opens around its calls into the program (``chipbench.window``,
``chipbench.ingest``, ``chipbench.step``, ``chipbench.loss_read``,
``chipbench.request``).  :class:`FlashScope` wraps the program's attention
entry (``repro_torch.kernels.ops.flash_attention``) for a traced run: each
call opens ``chipbench.flash_fwd`` and, under autograd, its backward runs
inside ``chipbench.flash_bwd`` (an identity node on the output opens it,
one on the inputs closes it); every call's work is counted from its shapes
(:mod:`chipbench.counts`).

:func:`finish` reads the trace through the profiler's correlation: each
device operation's correlation id names the host call that launched it,
and the innermost benchmark span open on that thread at that moment is
where its time goes.  No kernel is known by name.  The device's busy time
is the union of its operations' intervals inside ``chipbench.window``
(on one stream the sum of their times, as ``launch/profile_serve.py``
counts it); a serving cell's is also read inside its
``chipbench.request`` spans alone.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from chipbench import counts

FWD, BWD, WINDOW = "chipbench.flash_fwd", "chipbench.flash_bwd", "chipbench.window"
REQUEST = "chipbench.request"


class _Open(torch.autograd.Function):
    """Identity on attention's output; its backward opens the backward span
    and counts the backward's work."""

    @staticmethod
    def forward(ctx, o, owner, shape):
        ctx.owner, ctx.shape = owner, shape
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        rf = record_function(BWD)
        rf.__enter__()
        ctx.owner.open.append(rf)
        ctx.owner.add(counts.flash_bwd(*ctx.shape))
        return g, None, None


class _Close(torch.autograd.Function):
    """Identity on attention's inputs; its backward closes the span."""

    @staticmethod
    def forward(ctx, q, k, v, owner):
        ctx.owner = owner
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        if ctx.owner.open:
            ctx.owner.open.pop().__exit__(None, None, None)
        return gq, gk, gv, None


class FlashScope:
    """Wraps the program's attention entry while it is open."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.orig = ops, ops.flash_attention
        self.flops = self.nbytes = 0.0
        self.bound_s = 0.0
        self.calls = 0
        self.open: List = []
        ops.flash_attention = self._call

    def add(self, work: Tuple[float, float]) -> None:
        self.flops += work[0]
        self.nbytes += work[1]
        self.bound_s += counts.bound_s(*work)
        self.calls += 1

    def _call(self, q, k, v, *, causal=True, window=0, scale=None):
        B, T, H, D = q.shape
        shape = (B, T, k.shape[1], H, k.shape[2], D, causal, window, q.element_size())
        with record_function(FWD):
            self.add(counts.flash_fwd(*shape))
            grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
            if grad:
                q, k, v = _Close.apply(q, k, v, self)
            o = self.orig(q, k, v, causal=causal, window=window, scale=scale)
            return _Open.apply(o, self, shape) if grad else o

    def close(self) -> None:
        self.ops.flash_attention = self.orig


def start():
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def _overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """The length of the intersection of two merged interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class _Spans:
    """Host spans per thread, for 'which span was open at time t'."""

    def __init__(self, events):
        by: Dict[int, List] = defaultdict(list)
        for e in events:
            by[e.start_thread_id()].append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        self.by = {t: sorted(v) for t, v in by.items()}
        self.starts = {t: [s for s, _, _ in v] for t, v in self.by.items()}

    def open_at(self, thread: int, t: int) -> Optional[Tuple[int, str]]:
        """(start, name) of the innermost span open on ``thread`` at
        ``t``, looked for among the 64 spans started last before it."""
        v = self.by.get(thread)
        if not v:
            return None
        i = bisect.bisect_right(self.starts[thread], t)
        for s, e, name in reversed(v[max(0, i - 64):i]):
            if s <= t < e:
                return s, name
        return None

    def at(self, thread: int, t: int) -> Optional[str]:
        found = self.open_at(thread, t)
        return None if found is None else found[1]

    def innermost(self, t: int) -> Optional[str]:
        """The innermost span open at ``t`` on any thread."""
        found = [f for f in (self.open_at(th, t) for th in self.by) if f]
        return max(found)[1] if found else None


def finish(prof, flash: Optional[FlashScope], top: int = 10) -> dict:
    """Stop the profiler and read the window from its trace."""
    prof.__exit__(None, None, None)
    torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type() == cuda and not e.is_user_annotation()]
    host = [e for e in events if e.device_type() != cuda]
    window = [e for e in host if e.name() == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no chipbench.window span")
    w0 = window[0].start_ns()
    w1 = w0 + window[0].duration_ns()
    # The runtime calls (cudaLaunchKernel, cudaMemcpyAsync, ...) share
    # their correlation id with the device operation they start.
    launches = {e.correlation_id(): e for e in host
                if not e.is_user_annotation() and e.name().startswith("cu")}
    ours = _Spans(e for e in host if e.is_user_annotation() and e.name().startswith("chipbench."))
    anyop = _Spans(e for e in host if not e.name().startswith("cu"))

    by_scope: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    iv = []
    for e in device:
        s, d = e.start_ns(), e.duration_ns()
        if s + d <= w0 or s >= w1:
            continue
        iv.append((max(s, w0), min(s + d, w1)))
        by_name[e.name()[:160]] += d / 1e9
        launch = launches.get(e.correlation_id())
        if launch is not None:
            where = ours.at(launch.start_thread_id(), launch.start_ns())
            if where in (FWD, BWD):
                by_scope[where] += d / 1e9
    busy = _merge(iv)
    busy_ns = sum(e - s for s, e in busy)
    # A serving cell's request spans: the device's busy share while the
    # server works, with the open loop's waits for arrivals left out.
    serving = _merge([(max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1))
                      for e in host if e.is_user_annotation() and e.name() == REQUEST])
    gaps = [(a[1], b[0]) for a, b in zip([(w0, w0)] + busy, busy + [(w1, w1)]) if b[0] > a[1]]
    idle: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        idle["host: " + (anyop.innermost(s) or "outside any op")] += (e - s) / 1e9
    rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "serving_s": sum(e - s for s, e in serving) / 1e9,
        "serving_busy_s": _overlap_ns(busy, serving) / 1e9,
        "flash_device_s": by_scope[FWD] + by_scope[BWD],
        "flash_fwd_s": by_scope[FWD], "flash_bwd_s": by_scope[BWD],
        "flash_bound_s": flash.bound_s if flash else 0.0,
        "flash_calls": flash.calls if flash else 0,
        "breakdown": {"device_ops": rank(by_name), "idle_gaps": rank(idle)},
    }


"""The benchmark's reading of a hybrid model's traced train window: the
scan's spans beside attention's, and the time of the port's mamba mixers.

:class:`ScanScope` wraps the program's scan entry
(``repro_torch.kernels.ops.ssm_scan``) as :class:`chipbench.trace.FlashScope`
wraps attention's: each call opens ``chipbench.scan_fwd``, and under
autograd its backward runs inside ``chipbench.scan_bwd`` (an identity node
on the output opens it, one on the inputs closes it); every call's work is
counted from its shapes (:mod:`chipbench.counts_hybrid`).  A call that
checkpointing recomputes is a call.

:func:`finish` reads :func:`chipbench.trace.finish`'s window and adds, from
the same profiler events and by the same correlation of each device
operation with the call that launched it:

* ``scan_device_s``: the device time of the operations launched while a
  scan span was the innermost benchmark span on the launching thread, with
  ``scan_bound_s`` and ``scan_calls`` beside it;
* ``mamba_mix_s``: the device time of the operations launched while the
  port's ``repro_torch.mamba.mix`` span was open on the launching thread
  (forward, recompute and backward); 0 where the program has no such span.

``kinds/train_hybrid.py`` runs ``kinds/train.py`` with this module in place
of :mod:`chipbench.trace`, so :class:`FlashScope` here opens both scopes.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

from chipbench import counts_hybrid as CH
from chipbench import trace as tr
from chipbench.trace import start  # noqa: F401

SCAN_FWD, SCAN_BWD = "chipbench.scan_fwd", "chipbench.scan_bwd"
MAMBA_MIX = "repro_torch.mamba.mix"


class _Open(torch.autograd.Function):
    """Identity on the scan's output; its backward opens the backward span
    and counts the backward's work."""

    @staticmethod
    def forward(ctx, y, owner, shape):
        ctx.owner, ctx.shape = owner, shape
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        rf = record_function(SCAN_BWD)
        rf.__enter__()
        ctx.owner.open.append(rf)
        ctx.owner.add(CH.scan_bwd(*ctx.shape))
        return g, None, None


class _Close(torch.autograd.Function):
    """Identity on the scan's inputs; its backward closes the span."""

    @staticmethod
    def forward(ctx, owner, *xs):
        ctx.owner = owner
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.owner.open:
            ctx.owner.open.pop().__exit__(None, None, None)
        return (None,) + gs


class ScanScope:
    """Wraps the program's scan entry while it is open."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.orig = ops, ops.ssm_scan
        self.bound_s = 0.0
        self.calls = 0
        self.open: List = []
        ops.ssm_scan = self._call

    def add(self, work: Tuple[float, float, float]) -> None:
        self.bound_s += CH.bound_s(*work)
        self.calls += 1

    def _call(self, x, dt, A, B, C, D, h0=None):
        Bt, T, I = x.shape
        sizes = {"x": x.element_size(), "dt": dt.element_size(),
                 "B": B.element_size(), "C": C.element_size()}
        shape = (Bt, T, I, A.shape[1], sizes)
        with record_function(SCAN_FWD):
            self.add(CH.scan_fwd(*shape))
            ins = [x, dt, A, B, C, D]
            at = [j for j, t in enumerate(ins) if t.requires_grad]
            grad = torch.is_grad_enabled() and bool(at)
            if grad:
                for j, t in zip(at, _Close.apply(self, *(ins[j] for j in at))):
                    ins[j] = t
            y, hT = self.orig(*ins, h0)
            return (_Open.apply(y, self, shape), hT) if grad else (y, hT)

    def close(self) -> None:
        self.ops.ssm_scan = self.orig


class FlashScope:
    """Attention's scope and the scan's, opened and closed together."""

    def __init__(self):
        self.flash, self.scan = tr.FlashScope(), ScanScope()

    def close(self) -> None:
        self.scan.close()
        self.flash.close()


class _Within:
    """Merged intervals of one span's occurrences, per thread."""

    def __init__(self, events, name: str):
        by: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for e in events:
            if e.name() == name:
                by[e.start_thread_id()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        self.iv = {t: tr._merge(v) for t, v in by.items()}
        self.starts = {t: [s for s, _ in v] for t, v in self.iv.items()}

    def __contains__(self, at: Tuple[int, int]) -> bool:
        thread, t = at
        v = self.iv.get(thread)
        if not v:
            return False
        i = bisect.bisect_right(self.starts[thread], t) - 1
        return i >= 0 and t < v[i][1]


def finish(prof, scope: FlashScope) -> dict:
    """Stop the profiler and read the window: :func:`chipbench.trace.finish`'s
    readings with the scan's and the mamba mixers'."""
    out = tr.finish(prof, scope.flash)
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type() != cuda]
    w = next(e for e in host if e.name() == tr.WINDOW)
    w0, w1 = w.start_ns(), w.start_ns() + w.duration_ns()
    launches = {e.correlation_id(): e for e in host
                if not e.is_user_annotation() and e.name().startswith("cu")}
    ours = tr._Spans(e for e in host if e.is_user_annotation()
                     and e.name().startswith("chipbench."))
    mixers = _Within((e for e in host if e.is_user_annotation()), MAMBA_MIX)
    scan_s = mix_s = 0.0
    for e in events:
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        s, d = e.start_ns(), e.duration_ns()
        launch = launches.get(e.correlation_id())
        if s + d <= w0 or s >= w1 or launch is None:
            continue
        at = (launch.start_thread_id(), launch.start_ns())
        if ours.at(*at) in (SCAN_FWD, SCAN_BWD):
            scan_s += d / 1e9
        if at in mixers:
            mix_s += d / 1e9
    out.update(scan_device_s=scan_s, scan_bound_s=scope.scan.bound_s,
               scan_calls=scope.scan.calls, mamba_mix_s=mix_s)
    return out

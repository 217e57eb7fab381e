"""Prefill cells: the port's ``serve.decode.make_prefill`` under an open loop.

Request batches of ``batch`` prompts of one length arrive whatever the
server is doing, at ``rate`` a second on average (fixed in the mix at about
four fifths of the most the card sustains); the server takes them in turn.
The schedule, each batch's length (drawn from ``lengths`` with
``length_weights``) and when it is due (``arrivals``: ``poisson``, gaps
drawn from an exponential; or ``gamma``, bursts, gaps whose standard
deviation is ``gap_cv`` times their mean), is drawn once from the mix's
own ``schedule_seed`` and never from ``--seed``: which lengths queue behind
which sets the tail, so every run serves the same work at the same times.
The prompts are drawn from ``--seed`` on the card.  Set-up makes the
weights and prefills one batch of each length.

A request's time to first token runs from when it was due to its first
token on the host, so a stall counts against the requests queued behind
it.  Before the window a sample of request batches is drawn from the
seed, ``check_per_length`` of each length among the first
``check_within`` (which every window serves); their first tokens
and the caches the prefill built are kept.  Once the window has closed and
the model is freed, the reference runs each sampled prompt, and the check
compares:

* ``first_token_gap``: the widest gap by which a served token's logit lies
  below the reference's best logit at that position;
* ``cache_rel_err``: over the sampled batches, the layers and K and V, the
  widest norm of the cache's difference from the reference's keys (after
  RoPE) and values, over the norm of the reference's.
"""

from __future__ import annotations

import bisect
import gc
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from chipbench import counts, harness, trace as tr, weights as W
from chipbench.kinds.train import checks, port_config

FAULTS = ("token",)


def schedule(mix: dict, n: int, rate: Optional[float] = None) -> Tuple[List[int], List[float]]:
    """The first ``n`` request batches: their lengths, and when each is due
    in seconds after the window opens (at ``rate``, the mix's by default;
    another rate scales the same gaps)."""
    rate = rate or mix["rate"]
    weights = np.asarray(mix["length_weights"], float)
    pick = np.random.default_rng([mix["schedule_seed"], 0])
    lens = pick.choice(mix["lengths"], size=n, p=weights / weights.sum())
    gen = np.random.default_rng([mix["schedule_seed"], 1])
    if mix["arrivals"] == "poisson":
        gaps = gen.standard_exponential(n)
    elif mix["arrivals"] == "gamma":    # bursts: gaps whose spread is gap_cv of their mean
        cv2 = mix["gap_cv"] ** 2
        gaps = gen.gamma(1 / cv2, cv2, n)
    else:
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    due = np.concatenate([[0.0], np.cumsum(gaps[:-1])]) / rate
    return [int(x) for x in lens], due.tolist()


def sample(seed: int, mix: dict) -> List[int]:
    """The request batches the check compares."""
    lens, _ = schedule(mix, mix["check_within"])
    rng = np.random.default_rng([seed, 4])
    picked: List[int] = []
    for L in mix["lengths"]:
        idx = [i for i, x in enumerate(lens) if x == L]
        if len(idx) < mix["check_per_length"]:
            raise ValueError(f"the schedule's first {mix['check_within']} batches "
                             f"hold {len(idx)} of length {L}")
        picked += [int(i) for i in rng.choice(idx, mix["check_per_length"], replace=False)]
    return sorted(picked)


class Session:
    def __init__(self, cell: harness.Cell, seed: int, device="cuda",
                 fault: Optional[str] = None):
        from repro_torch.models.transformer import Transformer
        from repro_torch.serve.decode import make_prefill

        if fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cell, self.seed, self.fault = cell, seed, fault
        self.device = torch.device(device)
        self.m, self.mix = cell.config["model"], cell.traffic
        self.cfg = port_config(self.m)
        self.model = Transformer(self.cfg, device=self.device)
        W.load_into(dict(self.model.named_parameters()), self.m, seed)
        self.prefill = {L: make_prefill(self.model, L) for L in self.mix["lengths"]}
        self.kept: Dict[int, tuple] = {}
        self.keep = set(sample(seed, self.mix))

    def prompt(self, i: int, L: int) -> torch.Tensor:
        return W.prompt(self.seed, i, self.mix["batch"], L, self.m["vocab"], self.device)

    @torch.inference_mode()
    def warm(self) -> None:
        for j, L in enumerate(self.mix["lengths"]):
            self.prefill[L](self.prompt(-1 - j, L))[0].cpu()

    @torch.inference_mode()
    def serve(self, i: int, tokens: torch.Tensor) -> float:
        """Request batch i: prefill, first tokens on the host; returns the
        time its first tokens reached the host."""
        with record_function(tr.REQUEST):
            tok, _, cache = self.prefill[tokens.shape[1]](tokens)
            if self.fault == "token" and i in self.keep:
                tok = (tok + 1) % self.m["vocab"]
            first = tok.cpu()
            done = time.perf_counter()
        if i in self.keep:
            self.kept[i] = (first, cache)
        return done

    def window(self, seconds: float, traced: bool, rate: Optional[float] = None) -> dict:
        """Serve every request due in the first ``seconds``; the window
        closes when the last of them has its first tokens."""
        lens, due = schedule(self.mix, self.mix["max_requests"], rate)
        n = bisect.bisect_left(due, seconds)
        if n == len(due):
            raise RuntimeError("the window outlasted max_requests")
        scope = tr.FlashScope() if traced else None
        prof = tr.start() if traced else None
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        ttft, service, late, flops = [], [], [], 0.0
        B = self.mix["batch"]
        with record_function("chipbench.window"):
            t0 = time.perf_counter()
            for i in range(n):
                L = lens[i]
                tokens = self.prompt(i, L)
                wait = t0 + due[i] - time.perf_counter()
                if wait > 0:
                    with record_function("chipbench.arrival_wait"):
                        time.sleep(wait)
                start = time.perf_counter()
                done = self.serve(i, tokens)
                ttft += [done - t0 - due[i]] * B
                service.append(done - start)
                late.append(start - t0 - due[i])
                flops += counts.prefill_flops(self.m, B, L)
            window_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        rd = {"kind": "prefill", "window_s": window_s, "requests": n * B, "batches": n,
              "ttft_s": ttft, "service_s": service, "late_s": late,
              "model_flops": flops, "peak_window_bytes": peak}
        if traced:
            scope.close()
            rd["trace"] = tr.finish(prof, scope)
        return rd

    def release(self) -> None:
        self.model = self.prefill = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


@torch.no_grad()
def compare(cell: harness.Cell, seed: int, kept: Dict[int, tuple], device,
            fp8: bool = False) -> Dict[str, float]:
    """The reference over every kept request batch: the served tokens'
    logit gaps and the caches' relative errors.  ``kept[i]`` holds the
    side's (first tokens, cache), the cache a list of per-layer
    ``{"k", "v"}``; with ``fp8`` the side is the control, the
    reference one precision down, whose own first tokens are judged."""
    ref = harness.reference(cell)
    m, mix = cell.config["model"], cell.traffic
    eps = cell.config["norm_eps"]
    weights = W.make_weights(m, seed, device)
    lens, _ = schedule(mix, mix["check_within"])
    gap, err = 0.0, 0.0
    for i, (first, cache) in sorted(kept.items()):
        tokens = W.prompt(seed, i, mix["batch"], lens[i], m["vocab"], device)
        kv = {}
        best = ref.prefill(m, eps, weights, tokens,
                           lambda l, k, v: kv.__setitem__(l, (k, v)))
        if fp8:
            side_kv = {}
            side = ref.prefill(m, eps, weights, tokens,
                               lambda l, k, v: side_kv.__setitem__(l, (k, v)), fp8=True)
            first = side[:, : m["vocab"]].argmax(-1).cpu()
            cache = [{"k": k, "v": v} for _, (k, v) in sorted(side_kv.items())]
        served = best.gather(1, first.to(best.device).long()[:, None])[:, 0]
        gap = max(gap, float((best[:, : m["vocab"]].max(-1).values - served).max()))
        for l, (k, v) in kv.items():
            for mine, want in ((cache[l]["k"], k), (cache[l]["v"], v)):
                mine = mine[:, : want.shape[1]].float()
                err = max(err, float(torch.linalg.vector_norm(mine - want)
                                     / torch.linalg.vector_norm(want)))
        del kv
    return {"first_token_gap": gap, "cache_rel_err": err}


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, start: float,
        device="cuda", fault: Optional[str] = None) -> harness.Outcome:
    marks = [("to the cell's run", time.perf_counter())]
    s = Session(cell, seed, device, fault)
    marks.append(("the session", time.perf_counter()))
    s.warm()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - start
    peak_setup = (torch.cuda.max_memory_allocated(s.device)
                  if s.device.type == "cuda" else 0)
    rd = s.window(seconds, traced)
    kept = s.kept
    s.release()
    del s
    missing = [i for i in sample(seed, cell.traffic) if i not in kept]
    values = compare(cell, seed, kept, torch.device(device))
    if missing:
        values = {k: math.inf for k in values}
    ttft_ms = np.asarray(rd["ttft_s"]) * 1e3
    e2e = {"ttft_ms_p95": float(np.percentile(ttft_ms, 95)), "setup_s": setup_s}
    return harness.Outcome(
        attempted=rd["requests"], failed=0, end_to_end=e2e, readings=rd,
        checks=checks(cell, values),
        memory_peak_bytes=max(peak_setup, rd["peak_window_bytes"]),
        notes=[f"window {rd['window_s']:.3f} s, {rd['batches']} request batches, "
               f"{harness.setup_note(start, marks)}, ttft p50 {np.median(ttft_ms):.3f} ms, "
               f"latest start {1e3 * max(rd['late_s']):.3f} ms after due"
               + (f"; sampled batches not served: {missing}" if missing else "")])

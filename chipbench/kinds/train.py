"""Training cells: the port's ``make_train_step`` fed by its ``TokenPipeline``.

Set-up builds one training state (the program's model with the
benchmark's weights, AdamW moments, step 0), a ``PreloadedStore`` of
``hosts`` hosts holding the seed's token samples under the mix's
consistency model, and the pipeline that reads them on one reader host in
the store's epoch order.  It drives that state through its first
``check_steps`` steps, which the check compares, and hands the same state
to the window.  Every step is the window's own: a batch from the pipeline,
the step, and the loss read that ``launch.train`` does after it.

The check, once the window has closed and the state is freed:

* ``ingest_bad_batches``: batches fed (the first steps' and the window's)
  that differ from the samples the reference's epoch order names;
* ``loss1_rel_gap``: the relative gap of the first step's loss (the later
  steps' losses are compared by the two numbers below: their gaps swing
  from seed to seed by a factor of a hundred, as bf16 rounding of the
  updated weights sends the two sides apart);
* ``grad1_leaf_gap``: each leaf's norm of the first gradient as the
  optimizer takes it (clipped; the program's from its first moment after
  one step, m / (1 - b1)), the gap between the two sides' norms over the
  larger of the reference's norm of that leaf and of the median leaf,
  worst leaf;
* ``change_leaf_gap``: the same of each leaf's change over the first
  steps, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import gc
import itertools
import math
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from chipbench import counts, harness, trace as tr, weights as W
from chipbench.reference import epoch as ref_epoch

FAULTS = ("half_batch", "frozen", "token")


def port_config(m: dict):
    from repro_torch.models.config import ModelConfig
    fields = dict(m)
    for key in ("dtype", "opt_state_dtype"):
        if key in fields:
            fields[key] = W.dtype_of(fields[key])
    return ModelConfig(**fields)


class Session:
    """One training state and its feed, built from the seed."""

    def __init__(self, cell: harness.Cell, seed: int, device="cuda",
                 fault: Optional[str] = None):
        from repro_torch.data.dlio import PreloadedStore
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.models.transformer import Transformer
        from repro_torch.train.optimizer import AdamWConfig, adamw_init
        from repro_torch.train.train_step import make_train_step

        if fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cell, self.seed, self.fault = cell, seed, fault
        self.device = torch.device(device)
        m, t = cell.config["model"], cell.traffic
        self.m, self.t = m, t
        self.B, self.T = t["batch"], t["seq"]
        self.cfg = port_config(m)
        model = Transformer(self.cfg, device=self.device)
        W.load_into(dict(model.named_parameters()), m, seed)
        model.requires_grad_(True)
        self.opt = AdamWConfig(**t["opt"], state_dtype=self.cfg.opt_state_dtype)
        self.state = {"params": model,
                      "opt": adamw_init(dict(model.named_parameters()), self.opt),
                      "step": torch.zeros((), dtype=torch.int32, device=self.device)}
        self.step_fn = make_train_step(self.cfg, self.opt,
                                       num_microbatches=t["microbatches"])
        n = t["hosts"] * t["samples_per_host"]
        samples = W.corpus(seed, n, self.T, m["vocab"])
        self.store = PreloadedStore(t["consistency"], t["hosts"],
                                    t["samples_per_host"],
                                    procs_per_host=t["procs_per_host"],
                                    samples=list(samples))
        self.store.preload()
        pipe = TokenPipeline(self.store, self.cfg, self.B, self.T, seed=seed,
                             device=self.device)
        self.feed = itertools.chain.from_iterable(
            pipe.batches(e, reader_host=t["reader_host"]) for e in itertools.count())
        self.fed: List[torch.Tensor] = []

    # -- the timed path ------------------------------------------------------
    def next_batch(self) -> Dict[str, torch.Tensor]:
        batch = next(self.feed)
        if self.fault == "token" and len(self.fed) == 1:
            batch["tokens"][0, 0] = (batch["tokens"][0, 0] + 1) % self.m["vocab"]
        self.fed.append(batch["tokens"])
        return batch

    def step(self, batch):
        if self.fault == "half_batch":
            batch = {k: v[: self.B // 2] for k, v in batch.items()}
        if self.fault == "frozen":
            from repro_torch.train.train_step import loss_fn
            with torch.no_grad():
                loss, _ = loss_fn(self.state["params"], batch, self.cfg)
            return {"loss": loss}
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics

    # -- what the check compares ---------------------------------------------
    def first_steps(self, n: int) -> dict:
        """The first n steps; their losses, the first gradient's leaf norms
        from the moments after step 1, and each leaf's change after n."""
        losses, grad1 = [], None
        for i in range(n):
            losses.append(float(self.step(self.next_batch())["loss"]))
            if i == 0:
                ms = self.state["opt"]["m"]
                norms = torch.stack([torch.linalg.vector_norm(v.float()) for v in ms.values()])
                grad1 = dict(zip(ms, (norms / (1 - self.opt.b1)).tolist()))
        return {"loss": losses, "grad1": grad1,
                "change": change_norms(dict(self.state["params"].named_parameters()),
                                       self.m, self.seed)}

    def window(self, seconds: float, traced: bool) -> dict:
        """Steps until ``seconds`` have passed, each with its ingest and its
        loss read; the window's readings."""
        from repro_torch.core.basefs import EventKind
        ledger = self.store.fs.ledger
        rpcs0 = ledger.count(EventKind.RPC, "query")
        ingest, losses = [], []
        scope = tr.FlashScope() if traced else None
        prof = tr.start() if traced else None
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        with record_function("chipbench.window"):
            t0 = time.perf_counter()
            while True:
                with record_function("chipbench.ingest"):
                    ti = time.perf_counter()
                    batch = self.next_batch()
                    ingest.append(time.perf_counter() - ti)
                with record_function("chipbench.step"):
                    metrics = self.step(batch)
                with record_function("chipbench.loss_read"):
                    losses.append(float(metrics["loss"]))
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        rd = {"kind": "train", "window_s": window_s, "steps": len(losses),
              "tokens": len(losses) * self.B * self.T,
              "ingest_s": ingest, "ingest_rpcs": ledger.count(EventKind.RPC, "query") - rpcs0,
              "model_flops": len(losses) * counts.train_step_flops(self.m, self.B, self.T),
              "peak_window_bytes": peak, "losses": losses}
        if traced:
            scope.close()
            rd["trace"] = tr.finish(prof, scope)
        return rd

    def release(self) -> None:
        self.state = self.step_fn = self.feed = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


@torch.no_grad()
def change_norms(params: Dict[str, torch.Tensor], m: dict, seed: int) -> Dict[str, float]:
    """Each leaf's norm of its change from the seed's initial weights."""
    device = next(iter(params.values())).device
    out = {}
    for spec, w0 in W.leaves(m, seed, device):
        out[spec.name] = float(torch.linalg.vector_norm(params[spec.name].float() - w0.float()))
    return out


# -- the check ---------------------------------------------------------------
def expected_batches(cell: harness.Cell, seed: int, n: int) -> List[np.ndarray]:
    """The reference's first n batches: the store's epoch order over the
    seed's samples, worked out again."""
    t, m = cell.traffic, cell.config["model"]
    samples = W.corpus(seed, t["hosts"] * t["samples_per_host"], t["seq"], m["vocab"])
    order = ref_epoch.batch_order(t["hosts"] * t["samples_per_host"], t["hosts"],
                                  t["procs_per_host"], seed, t["batch"], n)
    return [samples[idx].astype(np.int64) for idx in order]


def reference_run(cell: harness.Cell, seed: int, device, fp8: bool = False) -> dict:
    """The reference's first steps from the seed's weights and batches."""
    ref = harness.reference(cell)
    m, t = cell.config["model"], cell.traffic
    n = t["check_steps"]
    batches = [torch.from_numpy(b).to(device) for b in expected_batches(cell, seed, n)]
    weights = W.make_weights(m, seed, device)
    out = ref.train(m, cell.config["norm_eps"], weights, batches, t["opt"], fp8=fp8)
    out["change"] = change_norms(weights, m, seed)
    del weights
    return out


def leaf_gap(side: Dict[str, float], ref: Dict[str, float], names=None) -> float:
    names = list(ref) if names is None else names
    med = statistics.median(ref[n] for n in names)
    return max(abs(side[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


def numbers(side: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared: ``side`` is the program's (or a control's)
    first steps, ``ref`` the reference's."""
    med = statistics.median(ref["grad1_raw"].values())
    moved = [n for n, g in ref["grad1_raw"].items() if g >= 1e-3 * med]
    return {
        "loss1_rel_gap": abs(side["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
        "grad1_leaf_gap": leaf_gap(side["grad1"], ref["grad1"]),
        "change_leaf_gap": leaf_gap(side["change"], ref["change"], moved),
    }


def ingest_bad(fed: List[torch.Tensor], cell: harness.Cell, seed: int) -> int:
    want = expected_batches(cell, seed, len(fed))
    return sum(not np.array_equal(f.cpu().numpy(), w) for f, w in zip(fed, want))


def checks(cell: harness.Cell, values: Dict[str, float]) -> List[harness.Check]:
    return [harness.Check(k, float(values[k]), float(cell.limits[k])) for k in cell.limits]


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, start: float,
        device="cuda", fault: Optional[str] = None) -> harness.Outcome:
    marks = [("to the cell's run", time.perf_counter())]
    s = Session(cell, seed, device, fault)
    marks.append(("the session", time.perf_counter()))
    first = s.first_steps(cell.traffic["check_steps"])
    marks.append(("the first steps", time.perf_counter()))
    setup_s = marks[-1][1] - start
    peak_setup = torch.cuda.max_memory_allocated(s.device) if s.device.type == "cuda" else 0
    rd = s.window(seconds, traced)
    fed, losses = s.fed, rd.pop("losses")
    s.release()
    del s
    values = {"ingest_bad_batches": ingest_bad(fed, cell, seed)}
    values.update(numbers(first, reference_run(cell, seed, torch.device(device))))
    e2e = {"train_tokens_per_s": rd["tokens"] / rd["window_s"], "setup_s": setup_s}
    return harness.Outcome(
        attempted=rd["steps"], failed=sum(not math.isfinite(x) for x in losses),
        end_to_end=e2e, readings=rd, checks=checks(cell, values),
        memory_peak_bytes=max(peak_setup, rd["peak_window_bytes"]),
        notes=[f"window {rd['window_s']:.3f} s, {rd['steps']} steps, "
               f"{harness.setup_note(start, marks)}, first losses {first['loss']}"])

"""Training cells of a hybrid Mamba / attention model (Jamba): the port's
``make_train_step`` fed by its ``TokenPipeline``, as ``kinds/train.py``
runs every training cell.

This kind is ``kinds/train.py`` itself, loaded as a module of its own with
four of its names bound to the hybrid model's: the weights
(:mod:`chipbench.weights_hybrid`: Jamba's leaves and Mamba's initial
draws), the counts (:mod:`chipbench.counts_hybrid`: model FLOPs of mamba
and attention layers), the trace (:mod:`chipbench.trace_hybrid`: the
scan's spans beside attention's, and the port's ``repro_torch.mamba.mix``
span) and the port's config (:class:`repro_torch.models.config.HybridConfig`).
The session, the window, the check and what it compares are that module's,
unchanged; the readings say ``"kind": "train"``, so the training cells'
per-layer metrics read them.
"""

from __future__ import annotations

from pathlib import Path

from chipbench import counts_hybrid, harness, trace_hybrid, weights_hybrid
from chipbench.weights import dtype_of


def port_config(m: dict):
    from repro_torch.models.config import HybridConfig
    fields = dict(m, pattern=tuple(m["pattern"]))
    for key in ("dtype", "opt_state_dtype"):
        if key in fields:
            fields[key] = dtype_of(fields[key])
    return HybridConfig(**fields)


base = harness.load_module(Path(__file__).with_name("train.py"), "chipbench_kind_train_for_hybrid")
base.W, base.counts, base.tr, base.port_config = (weights_hybrid, counts_hybrid, trace_hybrid,
                                                  port_config)

FAULTS = base.FAULTS
Session, reference_run, numbers, checks = (base.Session, base.reference_run, base.numbers,
                                           base.checks)


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, start: float,
        device="cuda", fault=None) -> harness.Outcome:
    port_config(cell.config["model"])       # a program without HybridConfig stops here
    return base.run(cell, seed, seconds, traced, start, device, fault)

"""The check that decides ``correct`` fails what it should.

* On the CPU, at a test's size: a run driven past the harness's look for a
  card, with the timed path broken underneath (half of each batch left
  out, a step that returns its state unchanged, a token altered where it
  is produced), comes out not correct under the cell's own limits; the
  same run unbroken comes out correct.
* On the card (``gpu``), at each cell's own size: the control, the
  reference put in the program's place one precision down (float8
  products), fails the cell's limits on a seed, where the program passes
  them.
"""

from __future__ import annotations

import time

import pytest
import torch

from conftest import tiny_cell

from chipbench import calibrate, harness
from chipbench.kinds import prefill as PK, train as TK

TRAIN = ["starcoder2-train-2k", "phi35moe-train-4k"]
SEED = 2 ** 31 + 101


def _correct(out) -> bool:
    return all(c.ok for c in out.checks)


@pytest.mark.parametrize("fault", TK.FAULTS)
@pytest.mark.parametrize("workload", TRAIN)
def test_train_faults_come_out_not_correct(workload, fault):
    out = TK.run(tiny_cell(workload), SEED, 0.2, False, time.perf_counter(),
                 device="cpu", fault=fault)
    assert out.attempted >= 1
    assert not _correct(out), harness.check_lines(out.checks)


@pytest.mark.parametrize("fault", PK.FAULTS)
def test_prefill_faults_come_out_not_correct(fault):
    out = PK.run(tiny_cell("starcoder2-prefill-1k4k"), SEED, 0.5, False,
                 time.perf_counter(), device="cpu", fault=fault)
    assert not _correct(out), harness.check_lines(out.checks)


@pytest.mark.parametrize("workload", TRAIN + ["starcoder2-prefill-1k4k"])
def test_an_unbroken_run_reads_small_and_feeds_the_right_samples(workload):
    """Unbroken, at this size the numbers sit far under the faults'
    (their limits are set at the cell's own size, on the card)."""
    cell = tiny_cell(workload)
    kind = TK if cell.traffic["kind"] == "train" else PK
    out = kind.run(cell, SEED, 0.3, False, time.perf_counter(), device="cpu")
    values = {c.name: c.value for c in out.checks}
    assert values.pop("ingest_bad_batches", 0) == 0
    assert max(values.values()) < 0.05, values


@pytest.mark.gpu
@pytest.mark.parametrize("workload", TRAIN + ["starcoder2-prefill-1k4k"])
def test_control_fails_on_the_card(cuda, workload):
    cell = harness.load_cell(workload)
    if cell.traffic["kind"] == "train":
        row = calibrate.train_seed(cell, 3_000_000_001, True, False, cuda)
    else:
        row = calibrate.prefill_seed(cell, 3_000_000_001, True, False, cuda, 12.0)
    limits = cell.limits
    assert all(row["program"][k] <= v for k, v in limits.items() if k in row["program"]), row
    assert any(row["control"][k] > v for k, v in limits.items() if k in row["control"]), row
    torch.cuda.empty_cache()

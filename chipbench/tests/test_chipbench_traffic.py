"""A prefill mix's schedule and the serving cell's idle share.

The schedule (each request batch's length and when it is due) comes from
the mix's own ``schedule_seed``, so every run of a cell serves the same
work at the same times whatever its ``--seed``; the device's idle share of
a serving cell is read inside its request spans only.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

from chipbench import harness, trace as tr
from chipbench.kinds import prefill as PK

MIX = harness.load_cell("starcoder2-prefill-1k4k").traffic


def test_the_schedule_is_the_mixs_and_not_the_seeds():
    lens, due = PK.schedule(MIX, 3000)
    again = PK.schedule(copy.deepcopy(MIX), 3000)
    assert (lens, due) == again
    assert set(lens) == set(MIX["lengths"])
    assert due[0] == 0.0 and all(b > a for a, b in zip(due, due[1:]))
    # Poisson arrivals at the mix's rate: the mean gap within 5%.
    assert abs(np.mean(np.diff(due)) * MIX["rate"] - 1) < 0.05
    # Equal weights: each length about a third of the batches.
    for L in MIX["lengths"]:
        assert abs(lens.count(L) / len(lens) - 1 / 3) < 0.05
    # Seeds pick which batches are compared, never the work.
    assert PK.sample(11, MIX) != PK.sample(12, MIX)


@pytest.mark.parametrize("arrivals", ["poisson", "gamma"])
def test_another_rate_scales_the_same_gaps(arrivals):
    mix = dict(MIX, arrivals=arrivals, gap_cv=3.0)
    lens, due = PK.schedule(mix, 200)
    lens2, due2 = PK.schedule(mix, 200, rate=2 * mix["rate"])
    assert lens2 == lens
    assert np.allclose(np.asarray(due2) * 2, due)


def test_bursts_spread_the_gaps_as_the_mix_says():
    gaps = np.diff(PK.schedule(dict(MIX, arrivals="gamma", gap_cv=3.0), 20000)[1]) * MIX["rate"]
    assert abs(gaps.mean() - 1) < 0.1
    assert abs(gaps.std() / gaps.mean() - 3.0) < 0.3


def test_weights_and_a_new_schedule_seed_change_the_draw():
    lens, _ = PK.schedule(dict(MIX, length_weights=[0, 0, 1]), 100)
    assert set(lens) == {MIX["lengths"][-1]}
    other, _ = PK.schedule(dict(MIX, schedule_seed=MIX["schedule_seed"] + 1), 100)
    assert other != PK.schedule(MIX, 100)[0]


def test_interval_overlap():
    a = [(0, 10), (20, 30), (40, 50)]
    b = [(5, 25), (45, 60)]
    assert tr._overlap_ns(a, b) == 5 + 5 + 5
    assert tr._overlap_ns(a, []) == 0
    assert tr._overlap_ns(a, a) == 30


def test_prefill_idle_share_reads_the_request_spans_only():
    reader = harness.metric_reader(harness.load_cell("starcoder2-prefill-1k4k"),
                                   "device_idle_share.prefill")
    trace = {"window_s": 30.0, "busy_s": 20.0, "serving_s": 24.0, "serving_busy_s": 18.0}
    assert reader.read({"kind": "prefill", "trace": trace}) == pytest.approx(25.0)
    assert reader.read({"kind": "prefill", "trace": dict(trace, serving_s=0.0)}) is None
    assert reader.read({"kind": "prefill"}) is None

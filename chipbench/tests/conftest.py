"""Shared fixtures of the benchmark's tests.

Run from the repository root: ``python -m pytest chipbench/tests -q`` on
the CPU; on the card ``python -m pytest -m gpu chipbench/tests -q``.
Whether there is a card is decided inside the ``cuda`` fixture, never
while a module is imported.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DENSE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=16,
                  d_ff=64, vocab=120, pad_vocab_to=64)
TINY_MOE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=16,
                d_ff=32, vocab=120, pad_vocab_to=64, moe_experts=4)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_cell(workload: str, **model):
    """The cell with its model cut to a CPU test's size: widths, depth and
    vocabulary small, everything else (kind, limits, the mix's shape) its
    own; a training mix's sequences 16 long, a prefill mix's 16 to 64,
    arriving 200 a second."""
    from chipbench import harness
    cell = copy.deepcopy(harness.load_cell(workload))
    tiny = TINY_MOE if cell.config["model"].get("moe_experts") else TINY_DENSE
    cell.config["model"] = dict(cell.config["model"], **tiny, **model)
    if cell.traffic["kind"] == "train":
        cell.traffic.update(seq=16, samples_per_host=8)
    else:
        cell.traffic.update(lengths=[16, 32, 64], check_within=12, check_per_length=2,
                            rate=200.0)
    return cell

"""The sample store's epoch order, worked out again.

The store deals a seeded permutation of its samples to ``hosts * procs``
reader processes, ``total // (hosts * procs)`` each in turn; the training
feed reads them in that order, ``batch`` at a time, and moves on to the
next epoch when too few are left for a batch.  The permutation is Python's
``random.Random`` shuffle, seeded by the low 32 bits of ``hash((seed,
epoch))`` (a tuple of ints hashes the same in every process).
"""

from __future__ import annotations

import random
from typing import List


def epoch_order(total: int, hosts: int, procs: int, seed: int, epoch: int) -> List[int]:
    idx = list(range(total))
    random.Random(hash((seed, epoch)) & 0xFFFFFFFF).shuffle(idx)
    readers = hosts * procs
    per = total // readers
    return idx[: readers * per]


def batch_order(total: int, hosts: int, procs: int, seed: int, batch: int,
                n: int) -> List[List[int]]:
    """The sample indices of the first ``n`` batches."""
    out: List[List[int]] = []
    epoch = 0
    while len(out) < n:
        flat = epoch_order(total, hosts, procs, seed, epoch)
        for b0 in range(0, len(flat) - batch + 1, batch):
            out.append(flat[b0:b0 + batch])
            if len(out) == n:
                break
        epoch += 1
    return out

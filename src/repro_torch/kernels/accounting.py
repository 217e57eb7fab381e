"""The work of the hand-written kernels when they are handed meta tensors.

A kernel wrapper given tensors on ``device="meta"`` (the dry run,
:mod:`repro_torch.launch.dryrun`) launches nothing: it returns empty
outputs of exactly the shapes and dtypes its CUDA kernel returns and
records here what the kernel would do on those inputs:

* ``flops``: arithmetic operations, the counts ``chip_smoke.py``'s bound
  column uses (flash attention: ``4 * D`` per visible (query, key) pair and
  head forward, ``10 * D`` backward; the scans and ``quantize`` per
  element, as commented there);
* ``special``: special-function operations (exp, sigmoid, sqrt);
* ``bytes``: each input read once and each output written once;
* ``dense_flops``: the same call's arithmetic if no masked tile were
  skipped (attention over all T x S pairs, the count a non-skipping
  attention such as the reference's chunked jnp one does; the scans and
  ``quantize`` skip nothing, so it equals ``flops``);
* ``launches``: calls.

Counts are kept per kernel name (the names of ``chip_smoke.py``'s kernels
line) in :data:`COUNTS` until :func:`reset`.  Under a mesh the wrappers
see one rank's local shards, so the counts are per rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

FIELDS = ("flops", "special", "bytes", "dense_flops", "launches")
COUNTS: Dict[str, Dict[str, float]] = {}
# Called as ``LISTENER(name, flops, dense_flops)`` on every record while set
# (``repro_torch.launch.hlostats.StepCounter`` attributes kernels with it).
LISTENER: Optional[Callable[[str, float, float], None]] = None


def reset() -> None:
    COUNTS.clear()


def snapshot() -> Dict[str, Dict[str, float]]:
    """A copy of the counts, by kernel name."""
    return {name: dict(c) for name, c in COUNTS.items()}


def record(name: str, *, flops: float, special: float, bytes: float,
           dense_flops: Optional[float] = None) -> None:
    c = COUNTS.setdefault(name, dict.fromkeys(FIELDS, 0))
    c["flops"] += flops
    c["special"] += special
    c["bytes"] += bytes
    dense = flops if dense_flops is None else dense_flops
    c["dense_flops"] += dense
    c["launches"] += 1
    if LISTENER is not None:
        LISTENER(name, flops, dense)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def visible_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through; query t at position
    ``S - T + t``, as ``repro_torch.kernels.ref.attention_ref`` places it."""
    pos = np.arange(T, dtype=np.int64) + (S - T)
    hi = np.minimum(S - 1, pos) if causal else np.full(T, S - 1, np.int64)
    lo = (np.maximum(0, pos - window + 1) if window > 0
          else np.zeros(T, np.int64))
    return int(np.maximum(0, hi - lo + 1).sum())


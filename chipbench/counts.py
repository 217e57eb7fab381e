"""The work counts the benchmark holds the program to, frozen here.

* Attention at the program's entry (``kernels.ops.flash_attention``): the
  visible (query, key) pairs of each call, ``4 * D`` operations per pair
  and head forward and ``10 * D`` backward (the five products of the
  backward, the scores recomputed among them), the counts of the port's
  ``kernels/accounting.py``.  Bytes: each input read once and each output
  written once, of the arithmetic alone: forward Q, K, V in and O out;
  backward Q, K, V, O, dO in and dQ, dK, dV out.  Whatever a kernel keeps
  besides (a log-sum-exp, a rounding residual) is its own business, so the
  bound is the same whatever implements attention.
* Model FLOPs of a step, from shapes, with nothing recomputed: every matrix
  product at 2 operations per multiply-add, attention's two products over
  the visible pairs, a backward twice its forward; an expert's products
  counted for the routed slots (top-k of every token), not the capacity's
  padding.
* The card's peaks: NVIDIA's data sheet for the H100 SXM, dense bf16.
"""

from __future__ import annotations

import numpy as np

PEAK_FLOPS = 989e12          # bf16 dense tensor-core operations a second
PEAK_BYTES = 3.35e12         # HBM3 bytes a second


def visible_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through; query t sits at position
    S - T + t, so the last query sees the last key."""
    pos = np.arange(T, dtype=np.int64) + (S - T)
    hi = np.minimum(S - 1, pos) if causal else np.full(T, S - 1, np.int64)
    lo = (np.maximum(0, pos - window + 1) if window > 0
          else np.zeros(T, np.int64))
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_fwd(B, T, S, H, K, D, causal=True, window=0, itemsize=2):
    """(operations, bytes) of one forward call."""
    pairs = B * H * visible_pairs(T, S, causal, window)
    nbytes = (2 * B * T * H * D + 2 * B * S * K * D) * itemsize
    return 4 * D * pairs, nbytes


def flash_bwd(B, T, S, H, K, D, causal=True, window=0, itemsize=2):
    """(operations, bytes) of one backward call."""
    pairs = B * H * visible_pairs(T, S, causal, window)
    nbytes = (4 * B * T * H * D + 4 * B * S * K * D) * itemsize
    return 10 * D * pairs, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _layer_forward(m: dict, B: int, T: int) -> float:
    D, H, K = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("d_head") or D // H
    F, E, k = m["d_ff"], m.get("moe_experts", 0), m.get("moe_topk", 0)
    N = B * T
    flops = 2 * N * D * (H + 2 * K) * hd + 2 * N * H * hd * D
    flops += 4 * hd * B * H * visible_pairs(T, T, True, m.get("local_window", 0))
    mats = 3 if m.get("ffn", "swiglu") in ("swiglu", "geglu") else 2
    if E:
        flops += 2 * N * D * E + k * N * mats * 2 * D * F
    else:
        flops += N * mats * 2 * D * F
    return flops


def train_step_flops(m: dict, B: int, T: int) -> float:
    """Forward and backward of one step over (B, T) tokens."""
    fwd = m["n_layers"] * _layer_forward(m, B, T) + 2 * B * T * m["d_model"] * m["vocab"]
    return 3 * fwd


def prefill_flops(m: dict, B: int, T: int) -> float:
    """A prefill of (B, T) prompts: every layer over every position, the
    output head at the last position only."""
    return m["n_layers"] * _layer_forward(m, B, T) + 2 * B * m["d_model"] * m["vocab"]

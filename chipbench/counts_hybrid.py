"""The work counts of a hybrid Mamba / attention step, frozen here as
:mod:`chipbench.counts` freezes attention's.

* Model FLOPs of a training step, from shapes, with nothing recomputed:
  every matrix product at 2 operations per multiply-add (a mamba mixer's
  ``in_proj``, ``x_proj``, ``dt_proj`` and ``out_proj``; attention's
  projections and its two products over the visible pairs; each layer's
  SwiGLU FFN; the head), a backward twice its forward.  The scan, the
  conv, the norms and the gates are elementwise and count nothing, as
  elementwise work counts nothing for attention models.
* The selective scan at the program's entry (``kernels.ops.ssm_scan``),
  from the arithmetic of ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
  ``y_t = C_t . h_t + D x_t`` alone, in the units of the port's kernel
  table: per state element and step the forward takes dt*A, dt*x*B, the
  state's multiply-add and the output's (6 f32 operations) and one exp,
  per channel and step dt*x and D*x + y (3); the backward rebuilds the
  state and takes the adjoint's terms of dC, dB, ddt, dA and dx, 20
  operations and one exp per state element and step.  Bytes: each input
  read once and each output written once, in the dtypes the call gives
  them (forward x, dt, A, B, C, D in and y, h_T out; backward those and dy
  in, a gradient of each out), so whatever a kernel keeps besides (the
  state at each chunk's start) is its own business and the bound is the
  same whatever implements the scan.
* Peaks of the H100 SXM: f32 on the CUDA cores 67 TFLOP/s, special
  functions 16 a clock an SM x 132 SMs x 1.98 GHz = 4.18 T/s, HBM3
  3.35 TB/s.
"""

from __future__ import annotations

from chipbench.counts import PEAK_BYTES, visible_pairs
from chipbench.weights import head_dim
from chipbench.weights_hybrid import layer_kind

PEAK_F32_FLOPS = 67e12
PEAK_SPECIAL = 16 * 132 * 1.98e9


def _mamba_forward(m: dict, B: int, T: int) -> float:
    D, I, R, N = m["d_model"], m["d_inner"], m["dt_rank"], m["ssm_state"]
    return 2 * B * T * (D * 2 * I + I * (R + 2 * N) + R * I + I * D)


def _attn_forward(m: dict, B: int, T: int) -> float:
    D, H, K, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], head_dim(m)
    proj = 2 * B * T * D * (H + 2 * K) * hd + 2 * B * T * H * hd * D
    return proj + 4 * hd * B * H * visible_pairs(T, T, True, 0)


def train_step_flops(m: dict, B: int, T: int) -> float:
    """Forward and backward of one step over (B, T) tokens."""
    ffn = 3 * 2 * B * T * m["d_model"] * m["d_ff"]
    fwd = 2 * B * T * m["d_model"] * m["vocab"]
    for i in range(m["n_layers"]):
        mix = _attn_forward if layer_kind(m, i) == "attn" else _mamba_forward
        fwd += mix(m, B, T) + ffn
    return 3 * fwd


def scan_fwd(Bt: int, T: int, I: int, N: int, sizes: dict):
    """(operations, special functions, bytes) of one forward call;
    ``sizes`` the element size of x, dt, B and C (A, D and h_T are f32)."""
    ops = Bt * T * I * (6 * N + 3)
    nbytes = (Bt * T * I * (2 * sizes["x"] + sizes["dt"])
              + Bt * T * N * (sizes["B"] + sizes["C"]) + 4 * (I * N + I + Bt * I * N))
    return ops, Bt * T * I * N, nbytes


def scan_bwd(Bt: int, T: int, I: int, N: int, sizes: dict):
    """(operations, special functions, bytes) of one backward call: the
    forward's inputs and dy read, a gradient of each input written."""
    ops = Bt * T * I * N * 20
    nbytes = (2 * Bt * T * I * (sizes["x"] + sizes["dt"]) + Bt * T * I * sizes["x"]
              + 2 * Bt * T * N * (sizes["B"] + sizes["C"]) + 2 * 4 * (I * N + I))
    return ops, Bt * T * I * N, nbytes


def bound_s(ops: float, special: float, nbytes: float) -> float:
    """The least time the card could take: the largest of the three."""
    return max(ops / PEAK_F32_FLOPS, special / PEAK_SPECIAL, nbytes / PEAK_BYTES)

"""The benchmark's frozen work counts against hand counts and against the
port's own accounting of its kernels (``kernels/accounting.py``)."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_cell

from chipbench import counts


def test_visible_pairs_by_hand():
    assert counts.visible_pairs(4, 4, True, 0) == 10
    assert counts.visible_pairs(4, 4, False, 0) == 16
    # Two queries at positions 2 and 3 of four keys: 3 + 4.
    assert counts.visible_pairs(2, 4, True, 0) == 7
    # A window of 2 keys: 1 + 2 + 2 + 2.
    assert counts.visible_pairs(4, 4, True, 2) == 7


def test_flash_counts_by_hand_with_gqa():
    B, T, S, H, K, D = 2, 4, 4, 4, 2, 8
    flops, nbytes = counts.flash_fwd(B, T, S, H, K, D, True, 0, 2)
    assert flops == 4 * D * B * H * 10
    # Q and O at H heads, K and V at K heads, 2 bytes each.
    assert nbytes == 2 * (2 * B * T * H * D + 2 * B * S * K * D)
    flops, nbytes = counts.flash_bwd(B, T, S, H, K, D, True, 0, 2)
    assert flops == 10 * D * B * H * 10
    assert nbytes == 2 * (4 * B * T * H * D + 4 * B * S * K * D)


SHAPES = [(2, 64, 64, 8, 2, 64, True, 0), (1, 32, 96, 4, 4, 128, True, 0),
          (3, 48, 48, 6, 1, 32, False, 0), (2, 80, 80, 4, 2, 64, True, 24)]


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_counts_match_the_ports_accounting(shape):
    """The port's kernels record their work on meta tensors: the same
    operations; the same bytes, less the log-sum-exp its backward reads."""
    from repro_torch.kernels import accounting as acc
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    B, T, S, H, K, D, causal, window = shape
    meta = dict(device="meta", dtype=torch.bfloat16)
    q, o = torch.empty(B, T, H, D, **meta), torch.empty(B, T, H, D, **meta)
    k, v = torch.empty(B, S, K, D, **meta), torch.empty(B, S, K, D, **meta)
    lse = torch.empty(B, H, T, device="meta", dtype=torch.float32)
    acc.reset()
    flash_attention_cuda(q, k, v, causal=causal, window=window)
    flash_attention_bwd_cuda(q, k, v, o, lse, o, causal=causal, window=window)
    got = acc.snapshot()
    fwd = counts.flash_fwd(B, T, S, H, K, D, causal, window, 2)
    bwd = counts.flash_bwd(B, T, S, H, K, D, causal, window, 2)
    assert got["flash_attention"]["flops"] == fwd[0]
    assert got["flash_attention"]["bytes"] == fwd[1]
    assert got["flash_attention_bwd"]["flops"] == bwd[0]
    assert got["flash_attention_bwd"]["bytes"] == bwd[1] + lse.numel() * 4


def test_bound_takes_the_larger():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_step_flops_by_hand():
    m = dict(n_layers=2, d_model=8, n_heads=2, n_kv_heads=1, d_head=4, d_ff=16,
             vocab=10, ffn="gelu")
    B, T, N = 1, 3, 3
    layer = (2 * N * 8 * (2 + 2) * 4 + 2 * N * 2 * 4 * 8   # projections
             + 4 * 4 * B * 2 * 6                           # 6 causal pairs
             + N * 2 * 2 * 8 * 16)                         # gelu FFN
    head = 2 * N * 8 * 10
    assert counts.train_step_flops(m, B, T) == 3 * (2 * layer + head)
    assert counts.prefill_flops(m, B, T) == 2 * layer + 2 * B * 8 * 10
    moe = dict(m, ffn="swiglu", moe_experts=4, moe_topk=2)
    mlayer = layer - N * 2 * 2 * 8 * 16 + 2 * N * 8 * 4 + 2 * N * 3 * 2 * 8 * 16
    assert counts.prefill_flops(moe, B, T) == 2 * mlayer + 2 * B * 8 * 10


@pytest.mark.parametrize("workload", ["starcoder2-prefill-1k4k", "phi35moe-train-4k"])
def test_prefill_flops_match_a_flop_counter(workload):
    """The port's tiny prefill on the CPU under ``FlopCounterMode``: its
    attention is the plain one over all T x T pairs, the rest the same."""
    from torch.utils.flop_counter import FlopCounterMode
    from chipbench import weights as W
    from chipbench.kinds.train import port_config
    from repro_torch.models.transformer import Transformer
    m = tiny_cell(workload, dtype="float32").config["model"]
    B, T = 2, 12
    model = Transformer(port_config(m), device="cpu")
    W.load_into(dict(model.named_parameters()), m, 1)
    tokens = W.prompt(1, 0, B, T, m["vocab"], "cpu")
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        model.prefill(tokens, T)
    hd, H = m["d_head"], m["n_heads"]
    visible = counts.visible_pairs(T, T, True, 0)
    dense = m["n_layers"] * 4 * hd * B * H * (T * T - visible)
    want = counts.prefill_flops(m, B, T) + dense
    # The port's head runs over the padded vocabulary.
    want += 2 * B * m["d_model"] * (W.vocab_padded(m) - m["vocab"])
    if m.get("moe_experts"):
        # The port runs every expert over its capacity's rows, counts the
        # router's einsum, and the benchmark counts the routed slots only.
        from repro_torch.models.moe import capacity
        cfg = port_config(m)
        C = capacity(cfg, B * T)
        routed = m["moe_topk"] * B * T
        want += m["n_layers"] * (m["moe_experts"] * C - routed) * 3 * 2 * m["d_model"] * m["d_ff"]
    assert fc.get_total_flops() == want

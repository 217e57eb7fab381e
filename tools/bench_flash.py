#!/usr/bin/env python3
"""Time the port's bf16 flash-attention kernels at their main shapes on one CUDA card.

    python3 tools/bench_flash.py [--fwd] [--bwd] [--src DIR]

Imports ``flash_attention`` from the tree at DIR (default: this checkout's
``src/``), so the kernels build from that tree's sources, and times them
with ``chip_smoke``'s inputs and timer.  With neither flag, both parts run.

- ``--fwd``: the forward (serving's call, no log-sum-exp), twice at each
  main shape: qwen3-32b's prefill, starcoder2-3b's training shape,
  whisper-small's encoder and cross-attention, llama3-405b's, phi3.5-moe's
  and granite-moe's prefill (head dims 64 and 128), paligemma-3b's
  training shape and recurrentgemma-9b's local serving shape (head dim
  256, window 2048).  Beside each: the path the call took, its max abs
  error against the plain attention in f32, SDPA's time (``enable_gqa``,
  with a boolean mask where there is a window; a yardstick the port never
  calls) and the bound (4·D flops per visible pair at 989 TFLOP/s against
  q, k, v and o at 3.35 TB/s); then the host time of one call at a small
  shape, where the card does not hold the host back.
- ``--bwd``: the backward alone, from one forward's saved tensors, twice at
  starcoder2-3b's training shape (head dim 128), whisper-small's encoder
  and cross-attention and granite-moe's layer (64), phi3.5-moe's layer
  (128), recurrentgemma-9b's local training shape and paligemma-3b's
  training shape (256, the first with window 2048), with each kernel's
  device time from one more call under ``torch.profiler``, the bound (the
  five products of 2·D flops per visible pair at 989 TFLOP/s against q, k,
  v, o, dO, lse, dq, dk, dv at 3.35 TB/s) and autograd of SDPA's time (a
  yardstick the port never calls), by CUDA events around the calls and as
  the device time of its kernels under ``torch.profiler`` (with a boolean
  mask where there is a window).  The local shape takes fewer iterations.

To compare two commits on one card, unpack the other under ``build/``
(``git archive``) and run parent, change, change, parent on one card, one
after another.  Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def forward(torch, cs, fa, ref) -> dict:
    out = {}
    for name, shape in (("qwen3", cs.MAIN_SHAPE), ("starcoder2_train", cs.TRAIN_SHAPE),
                        ("whisper_encoder", cs.WHISPER_ENC_SHAPE),
                        ("whisper_cross", cs.WHISPER_CROSS_SHAPE),
                        ("llama3", cs.LLAMA3_SHAPE), ("phi3.5", cs.PHI_SHAPE),
                        ("granite", cs.GRANITE_SHAPE),
                        ("paligemma_train", cs.PALI_TRAIN_SHAPE),
                        ("recurrentgemma_local", cs.LOCAL_SHAPE)):
        B, T, S, H, K, D, causal, window = shape
        q, k, v = cs.attn_inputs(torch, shape, torch.bfloat16, seed=99)
        path = fa.PATHS[fa.fwd_path(q.dtype, D, fa._aligned(q, k, v))]

        def call():
            return fa.flash_attention_cuda(q, k, v, causal=causal, window=window)

        want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                 window=window)
        err = (call().float() - want).abs().max().item()
        del want
        ms = [cs.time_ms(torch, call, iters=20) for _ in range(2)]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window > 0:
            qpos = torch.arange(T, device="cuda")[:, None] + (S - T)
            kpos = torch.arange(S, device="cuda")[None, :]
            sdpa_args = dict(attn_mask=(kpos <= qpos) & (kpos > qpos - window))
        else:
            sdpa_args = dict(is_causal=causal)
        sdpa_ms = cs.time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **sdpa_args), iters=20)
        flops = 4 * D * cs.visible_pairs(T, S, causal, window) * B * H
        b_ms, b_by, _ = cs.bound(flops, cs.PEAK_BF16_FLOPS, 0, cs.nbytes(q, k, v, q))
        out[name] = {"shape": list(shape), "path": path, "max_abs_err": err,
                     "ms": ms, "sdpa_ms": sdpa_ms, "bound_ms": b_ms, "bound_by": b_by}
        print(f"forward {name} {shape} ({path}): {ms[0]:.4f} / {ms[1]:.4f} ms, sdpa "
              f"{sdpa_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, max abs err "
              f"{err:.3e}", flush=True)
        del q, k, v, qt, kt, vt, sdpa_args
        torch.cuda.empty_cache()
    # Host time of one call (the wrapper, the C entry point and the launch),
    # at a shape too small for the card to hold the host back.
    for D in (64, 128, 256):
        shape = (1, 128, 128, 2, 1, D, True, 0)
        q, k, v = cs.attn_inputs(torch, shape, torch.bfloat16, seed=98)
        for _ in range(20):
            fa.flash_attention_cuda(q, k, v, causal=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fa.flash_attention_cuda(q, k, v, causal=True)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        out[f"host_us_d{D}"] = host_us
        print(f"forward host time of one call at {shape}: {host_us:.1f} us", flush=True)
    return out


def device_ms(torch, fn, calls: int) -> float:
    """Device time of the kernels ``fn`` launches, per call, over ``calls``
    calls under ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / calls / 1e3


def backward(torch, cs, fa) -> dict:
    out = {}
    for name, shape, iters in (("starcoder2_train", cs.TRAIN_SHAPE, 20),
                               ("whisper_encoder", cs.WHISPER_ENC_SHAPE, 20),
                               ("whisper_cross", cs.WHISPER_CROSS_SHAPE, 20),
                               ("granite_train", cs.GRANITE_SHAPE, 20),
                               ("phi3.5_train", cs.PHI_SHAPE, 20),
                               ("recurrentgemma_local_train", cs.LOCAL_TRAIN_SHAPE, 5),
                               ("paligemma_train", cs.PALI_TRAIN_SHAPE, 20)):
        B, T, S, H, K, D, causal, window = shape
        q, k, v = cs.attn_inputs(torch, shape, torch.bfloat16, seed=96)
        dout = cs.randn(torch, torch.Generator(device="cuda").manual_seed(95),
                        q.shape, torch.bfloat16)
        o, lse, o_lo = fa._forward(q, k, v, causal, window, D ** -0.5, with_lse=True)
        path = fa.PATHS[fa.bwd_path(q.dtype, D, fa._aligned(q, k, v, dout))]

        def call():
            return fa.flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal=causal,
                                               window=window, o_lo=o_lo)

        ms = [cs.time_ms(torch, call, iters=iters) for _ in range(2)]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        by_kernel = {e.key[:60]: e.device_time_total / 1e3
                     for e in prof.key_averages() if e.device_time_total > 0}
        # SDPA's backward through autograd: CUDA events around the calls (the
        # host's autograd work included), and the device time of its kernels.
        if window > 0:
            qpos = torch.arange(T, device="cuda")[:, None] + (S - T)
            kpos = torch.arange(S, device="cuda")[None, :]
            sdpa_args = dict(attn_mask=(kpos <= qpos) & (kpos > qpos - window))
        else:
            sdpa_args = dict(is_causal=causal)
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            sdpa_out = torch.nn.functional.scaled_dot_product_attention(
                *(x.transpose(1, 2) for x in leaves), enable_gqa=True,
                **sdpa_args).transpose(1, 2)

            def sdpa_call():
                return torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True)

            sdpa_ms = cs.time_ms(torch, sdpa_call, iters=iters)
            sdpa_device_ms = device_ms(torch, sdpa_call, 5)
            del leaves, sdpa_out, sdpa_args
        flops = 10 * D * cs.visible_pairs(T, S, causal, window) * B * H
        b_ms, b_by, _ = cs.bound(flops, cs.PEAK_BF16_FLOPS, 0,
                                 cs.nbytes(q, k, v, o, dout, lse, q, k, v))
        out[name] = {"shape": list(shape), "path": path, "ms": ms,
                     "device_ms": sum(by_kernel.values()), "sdpa_ms": sdpa_ms,
                     "sdpa_device_ms": sdpa_device_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "device_ms_by_kernel": by_kernel}
        print(f"backward {name} {shape} ({path}): {ms[0]:.4f} / {ms[1]:.4f} ms "
              f"(device {sum(by_kernel.values()):.4f}), sdpa backward {sdpa_ms:.4f} "
              f"(device {sdpa_device_ms:.4f}), bound {b_ms:.4f} ms by {b_by}", flush=True)
        del q, k, v, dout, o, lse, o_lo
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fwd", action="store_true", help="time the forward")
    ap.add_argument("--bwd", action="store_true", help="time the backward")
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    both = not (args.fwd or args.bwd)
    import torch
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    out = {"src": args.src}
    if args.fwd or both:
        out["forward"] = forward(torch, cs, fa, ref)
    if args.bwd or both:
        out["backward"] = backward(torch, cs, fa)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

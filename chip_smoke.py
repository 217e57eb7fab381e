#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits nonzero
without the final result line:

1. Device: the card's name and power limit, from nvidia-smi.
2. Build: every CUDA kernel of the serving path, compiled from the
   sources under src/repro_torch/kernels/csrc with nvcc.
3. Kernel against plain: each kernel's wrapper against its plain PyTorch
   version on the card, over the reference's kernel test cases and the
   main-path shape (f32 atol/rtol 1e-4, bf16 2e-2).
4. Whole model, kernel against plain: qwen3-32b at full width, 2 layers,
   f32, B=1, T=256; prefill logits with the kernel against the same model
   with plain attention (atol 1e-3).
5. Main path: ``repro_torch.launch.serve`` for qwen3-32b at full width,
   8 layers, bf16, batch 4, prompt 1024, 32 greedy decode steps, with
   every kernel's launch count set to 0 just before and read just after.
6. Times at the main-path shape: kernel, plain version, the least time the
   card could take (bound), and one PyTorch library call as a yardstick
   (the port never calls it).
7. The ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published dense peaks of one H100 SXM (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # CUDA cores, outside the tensor cores
PEAK_BYTES = 3.35e12

# B, T, S, H, K, D, causal, window -- tests/test_kernels.py ATTN_CASES ...
ATTN_CASES = [
    (2, 16, 16, 4, 4, 8, True, 0),
    (1, 16, 16, 6, 2, 16, True, 0),
    (2, 8, 24, 4, 1, 8, True, 0),
    (1, 16, 16, 4, 2, 8, False, 0),
    (1, 32, 32, 4, 4, 8, True, 8),
    (1, 20, 20, 2, 2, 8, True, 0),
]
# ... and head dims, ragged tiles and fully masked rows (T > S) beyond them,
# on both paths of the kernel (bf16 with D in {16, 32, 64, 128} runs on the
# tensor cores; f32 and other head dims on the CUDA cores).
EXTRA_CASES = [
    (1, 40, 40, 4, 2, 256, True, 16),
    (2, 24, 8, 4, 2, 64, True, 0),
    (1, 33, 70, 8, 1, 128, False, 0),
    (1, 100, 100, 4, 2, 128, True, 24),
    (2, 65, 130, 8, 2, 64, True, 0),
    (1, 70, 70, 4, 4, 32, False, 0),
    (1, 50, 50, 2, 1, 96, True, 0),
]
MAIN_SHAPE = (4, 1024, 1024, 64, 8, 128, True, 0)   # qwen3-32b prefill, B=4
SERVE_ARGS = ["--arch", "qwen3-32b", "--layers", "8", "--batch", "4",
              "--prompt-len", "1024", "--steps", "32", "--device", "cuda",
              "--seed", "0"]


def phase(n: int, name: str, detail: str = "") -> None:
    print(f"[phase {n}] {name}: ok{' ' + detail if detail else ''}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def visible_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through; query t at position S-T+t."""
    n = 0
    for t in range(T):
        pos = S - T + t
        hi = min(S - 1, pos) if causal else S - 1
        lo = max(0, pos - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def attn_inputs(torch, case, dtype, seed):
    B, T, S, H, K, D, _, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, T, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, K, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, K, D), generator=g, device="cuda").to(dtype)
    return q, k, v


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_params
    from repro_torch.configs.registry import get_config

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase(1, "device", f"{kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load(fa.SOURCE)
    phase(2, "build", f"{fa.SOURCE} in {time.perf_counter() - t0:.2f} s")

    # -- 3. kernel against plain ----------------------------------------------
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    main_err = None
    for dtype, tol in tols.items():
        for i, case in enumerate(ATTN_CASES + EXTRA_CASES + [MAIN_SHAPE]):
            causal, window = case[6], case[7]
            q, k, v = attn_inputs(torch, case, dtype, seed=i)
            got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
            want = attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            bad = err > tol + tol * want.float().abs()
            check(not bool(bad.any()) and bool(torch.isfinite(got).all()),
                  f"flash_attention_cuda disagrees with attention_ref on "
                  f"{case} {dtype}: max abs err {err.max().item():.3e}")
            if case == MAIN_SHAPE and dtype == torch.bfloat16:
                main_err = err.max().item()
            del q, k, v, got, want, err, bad
    phase(3, "kernel against plain",
          f"{2 * (len(ATTN_CASES) + len(EXTRA_CASES) + 1)} cases; main-path "
          f"bf16 max abs err {main_err:.3e}")

    # -- 4. whole model at full width, kernel against plain -------------------
    import dataclasses
    cfg2 = dataclasses.replace(get_config("qwen3-32b"), n_layers=2,
                               dtype=torch.float32)
    model = init_params(cfg2, torch.Generator(device="cuda").manual_seed(1),
                        "cuda")
    toks = torch.randint(0, cfg2.vocab, (1, 256), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.inference_mode():
        with_kernel, _ = model.prefill(toks, 256)
        kernel_fn = ops.flash_attention
        ops.flash_attention = attention_ref
        try:
            with_plain, _ = model.prefill(toks, 256)
        finally:
            ops.flash_attention = kernel_fn
    torch.cuda.synchronize()
    werr = (with_kernel[..., :cfg2.vocab] - with_plain[..., :cfg2.vocab]).abs().max().item()
    check(bool(torch.isfinite(with_kernel).all()) and werr <= 1e-3,
          f"qwen3-32b 2-layer f32 prefill logits: kernel vs plain max abs "
          f"err {werr:.3e} > 1e-3")
    del model, with_kernel, with_plain
    torch.cuda.empty_cache()
    phase(4, "whole model kernel against plain",
          f"qwen3-32b 2 layers f32 B=1 T=256, max abs logit err {werr:.3e}")

    # -- 5. main path ---------------------------------------------------------
    fa.LAUNCHES = 0
    res = serve.run(SERVE_ARGS)
    launches = fa.LAUNCHES
    check(launches == res.cfg.n_layers,
          f"flash_attention_cuda launched {launches} times in the main path, "
          f"expected one per layer in prefill ({res.cfg.n_layers})")
    check(tuple(res.tokens.shape) == (4, 32), f"tokens {tuple(res.tokens.shape)}")
    check(bool(((res.tokens >= 0) & (res.tokens < res.cfg.vocab)).all()),
          "generated token outside [0, vocab)")
    check(all(bool(torch.isfinite(lg).all()) for lg in res.logits),
          "non-finite logits on the main path")
    phase(5, "main path",
          f"qwen3-32b 8 layers bf16 B=4 prompt 1024 decode 32: prefill "
          f"{res.prefill_ms:.3f} ms, decode {res.decode_ms_per_step:.3f} "
          f"ms/step, {res.decode_tok_s:.1f} tok/s; flash_attention launches "
          f"{launches}")
    del res
    torch.cuda.empty_cache()

    # -- 6. times at the main-path shape ----------------------------------------
    B, T, S, H, K, D, causal, window = MAIN_SHAPE
    q, k, v = attn_inputs(torch, MAIN_SHAPE, torch.bfloat16, seed=99)
    ms = time_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, causal=causal),
                 iters=20)
    plain_ms = time_ms(torch, lambda: attention_ref(q, k, v, causal=causal),
                       iters=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), iters=20)
    flops = 4 * D * visible_pairs(T, S, causal, window) * B * H
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    phase(6, "times", f"flash_attention bf16 {MAIN_SHAPE}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB; f32 CUDA-core bound "
          f"{flops / PEAK_F32_FLOPS * 1e3:.4f} ms)")

    # -- 7. kernels line and result -------------------------------------------
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/" + fa.SOURCE,
        "replaces": fa.REPLACES,
        "launches": launches,
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits nonzero
without the final result line:

1. Device: the card's name and power limit, from nvidia-smi.
2. Build: every CUDA kernel of the serving paths (flash attention, the
   selective scan, the RG-LRU), compiled from the sources under
   src/repro_torch/kernels/csrc with one nvcc per source, all started
   together.
3. Kernel against plain: each kernel's wrapper against its plain PyTorch
   version on the card, over the reference's kernel test cases, cases
   beyond them (an initial state, T not a multiple of the time tile,
   channels not a multiple of the block) and the main-path shapes, in f32
   and bf16.  Tolerances: f32 atol/rtol 1e-4, bf16 outputs 2e-2, the scans'
   f32 final states 1e-4.
4. Whole models at full width, f32, kernels against plain (atol 1e-3 on
   the last-position logits): qwen3-32b 2 layers, B=1, T=256;
   falcon-mamba-7b 2 layers, B=1, T=256; recurrentgemma-9b 3 layers (one
   rglru, rglru, local super-block), B=1, T=2100, past its 2048 window.
5. Main paths: ``repro_torch.launch.serve`` at full width, bf16, batch 4,
   32 greedy decode steps, with every kernel's launch count set to 0 just
   before each run and read just after: qwen3-32b 8 layers, prompt 1024
   (flash 8); falcon-mamba-7b 8 layers, prompt 1024 (ssm 8);
   recurrentgemma-9b 8 layers, prompt 3000 (rglru 6, flash 2).
6. Times at the main-path shapes: kernel, plain version, the least time
   the card could take (bound, from the bytes moved and the operations
   done) and one PyTorch library call as a yardstick where one computes
   the same function (the port never calls it).
7. The ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import dataclasses
import gc
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
# Special-function units (exp2, reciprocal, sqrt): 16 results per clock per
# SM (CUDA C++ Programming Guide, throughput table, compute capability 9.0)
# x 132 SMs x the 1.98 GHz boost clock that the 67 TFLOP/s f32 peak implies.
PEAK_SFU_OPS = 16 * 132 * 1.98e9

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
MAIN_SHAPE = (4, 1024, 1024, 64, 8, 128, True, 0)      # qwen3-32b prefill, B=4
LOCAL_SHAPE = (4, 3000, 3000, 16, 1, 256, True, 2048)  # recurrentgemma local
# Bt, T, I, N, with h0 -- tests/test_kernels.py SSM_CASES, then an initial
# state, T past the 16-step tile (20, 1000), I not a multiple of the
# 128-channel block, and the falcon-mamba-7b prefill shape.
SSM_CASES = [(1, 8, 4, 2, False), (2, 16, 8, 4, False), (1, 24, 6, 3, False),
             (2, 16, 8, 4, True), (2, 20, 200, 16, True),
             (1, 1000, 130, 16, False)]
SSM_MAIN = (4, 1024, 8192, 16, False)
# B, T, L, with h0 -- tests/test_kernels.py RGLRU_CASES, then T=20 (where the
# Pallas wrapper's unmasked padding breaks h_T), T=1000 with L not a multiple
# of the 64-channel block, and the recurrentgemma-9b prefill shape.
RGLRU_CASES = [(1, 8, 4, False), (2, 16, 8, False), (1, 13, 6, False),
               (1, 20, 6, False), (2, 20, 6, True), (2, 1000, 100, True)]
RGLRU_MAIN = (4, 3000, 4096, False)


def serve_args(arch: str, prompt: int) -> list:
    return ["--arch", arch, "--layers", "8", "--batch", "4", "--prompt-len",
            str(prompt), "--steps", "32", "--device", "cuda", "--seed", "0"]


MAIN_PATHS = [("qwen3-32b", serve_args("qwen3-32b", 1024)),
              ("falcon-mamba-7b", serve_args("falcon-mamba-7b", 1024)),
              ("recurrentgemma-9b", serve_args("recurrentgemma-9b", 3000))]


def phase(n: int, name: str, detail: str = "") -> None:
    print(f"[phase {n}] {name}: ok{' ' + detail if detail else ''}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def free() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def visible_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through; query t at position S-T+t."""
    n = 0
    for t in range(T):
        pos = S - T + t
        hi = min(S - 1, pos) if causal else S - 1
        lo = max(0, pos - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def randn(torch, g, shape, dtype=None):
    x = torch.randn(shape, generator=g, device="cuda")
    return x if dtype is None else x.to(dtype)


def attn_inputs(torch, case, dtype, seed):
    B, T, S, H, K, D, _, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (randn(torch, g, (B, T, H, D), dtype), randn(torch, g, (B, S, K, D), dtype),
            randn(torch, g, (B, S, K, D), dtype))


def ssm_inputs(torch, case, dtype, seed):
    """x, dt, A, B, C, D, h0 as the main path gives them: x, B, C in the
    working dtype, dt f32 (softplus'd), A negative, D and h0 f32."""
    Bt, T, I, N, with_h0 = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = randn(torch, g, (Bt, T, I), dtype)
    dt = torch.nn.functional.softplus(randn(torch, g, (Bt, T, I)))
    A = -torch.exp(randn(torch, g, (I, N)))
    Bm, Cm = randn(torch, g, (Bt, T, N), dtype), randn(torch, g, (Bt, T, N), dtype)
    D = randn(torch, g, (I,))
    return x, dt, A, Bm, Cm, D, (randn(torch, g, (Bt, I, N)) if with_h0 else None)


def rglru_inputs(torch, case, dtype, seed):
    B, T, L, with_h0 = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, a, i = (randn(torch, g, (B, T, L), dtype) for _ in range(3))
    return x, a, i, randn(torch, g, (L,)), (randn(torch, g, (B, L)) if with_h0 else None)


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, peak_flops: float, sfu: float, moved: int):
    """(bound ms, what binds, detail): the larger of the operations' time
    (arithmetic at ``peak_flops``, special functions at PEAK_SFU_OPS) and
    the bytes' time at PEAK_BYTES."""
    t_ops = max(flops / peak_flops, sfu / PEAK_SFU_OPS)
    t_bytes = moved / PEAK_BYTES
    detail = (f"{flops / 1e9:.3f} GFLOP at {peak_flops / 1e12:.0f} TFLOP/s, "
              f"{sfu / 1e6:.1f}M special-function ops at "
              f"{PEAK_SFU_OPS / 1e12:.2f} T/s, {moved / 1e6:.1f} MB at "
              f"{PEAK_BYTES / 1e12:.2f} TB/s")
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", detail)


def compare(torch, got, want, tol, what):
    """Max abs error of ``got`` against ``want``; raises beyond
    ``tol + tol*|want|`` or on a non-finite value."""
    err = (got.float() - want.float()).abs()
    bad = err > tol + tol * want.float().abs()
    check(not bool(bad.any()) and bool(torch.isfinite(got).all()),
          f"{what}: max abs err {err.max().item():.3e} beyond {tol}")
    return err.max().item()


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

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_params
    from repro_torch.configs.registry import get_config

    kernels = {"flash_attention": fa, "ssm_scan": ss, "rglru_scan": rs}
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

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
    _build.load_all(m.SOURCE for m in kernels.values())
    phase(2, "build", f"{', '.join(m.SOURCE for m in kernels.values())} in "
          f"{time.perf_counter() - t0:.2f} s")

    # -- 3. kernels against plain ---------------------------------------------
    main_err = {}
    n_cases = 0
    for dtype, tol in tols.items():
        for i, case in enumerate(ATTN_CASES + EXTRA_CASES + [MAIN_SHAPE, LOCAL_SHAPE]):
            causal, window = case[6], case[7]
            q, k, v = attn_inputs(torch, case, dtype, seed=i)
            got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
            want = ref.attention_ref(q, k, v, causal=causal, window=window)
            err = compare(torch, got, want, tol, f"flash_attention_cuda {case} {dtype}")
            if dtype == torch.bfloat16 and case in (MAIN_SHAPE, LOCAL_SHAPE):
                main_err[("flash_attention", case)] = err
            n_cases += 1
            del q, k, v, got, want
            free()
        for i, case in enumerate(SSM_CASES + [SSM_MAIN]):
            args = ssm_inputs(torch, case, dtype, seed=100 + i)
            y, hT = ss.ssm_scan_cuda(*args)
            y_ref, hT_ref = ref.ssm_scan_ref(*args)
            err = compare(torch, y, y_ref, tol, f"ssm_scan_cuda y {case} {dtype}")
            compare(torch, hT, hT_ref, 1e-4, f"ssm_scan_cuda h_T {case} {dtype}")
            if dtype == torch.bfloat16 and case == SSM_MAIN:
                main_err["ssm_scan"] = err
            n_cases += 1
            del args, y, hT, y_ref, hT_ref
            free()
        for i, case in enumerate(RGLRU_CASES + [RGLRU_MAIN]):
            args = rglru_inputs(torch, case, dtype, seed=200 + i)
            hs, hT = rs.rglru_scan_cuda(*args)
            hs_ref, hT_ref = ref.rglru_ref(*args)
            err = compare(torch, hs, hs_ref, tol, f"rglru_scan_cuda h {case} {dtype}")
            compare(torch, hT, hT_ref, 1e-4, f"rglru_scan_cuda h_T {case} {dtype}")
            if dtype == torch.bfloat16 and case == RGLRU_MAIN:
                main_err["rglru_scan"] = err
            n_cases += 1
            del args, hs, hT, hs_ref, hT_ref
            free()
    phase(3, "kernels against plain",
          f"{n_cases} cases; main-path bf16 max abs err: flash qwen3 "
          f"{main_err[('flash_attention', MAIN_SHAPE)]:.3e}, flash local "
          f"{main_err[('flash_attention', LOCAL_SHAPE)]:.3e}, ssm "
          f"{main_err['ssm_scan']:.3e}, rglru {main_err['rglru_scan']:.3e}")

    # -- 4. whole models at full width, kernels against plain -----------------
    plain = {"flash_attention": ref.attention_ref, "ssm_scan": ref.ssm_scan_ref,
             "rglru": ref.rglru_ref}
    details = []
    for arch, layers, T in (("qwen3-32b", 2, 256), ("falcon-mamba-7b", 2, 256),
                            ("recurrentgemma-9b", 3, 2100)):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  dtype=torch.float32)
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                            "cuda")
        toks = torch.randint(0, cfg.vocab, (1, T), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(2))
        with torch.inference_mode():
            with_kernel, cache_k = model.prefill(toks, T)
            saved = {name: getattr(ops, name) for name in plain}
            for name, fn in plain.items():
                setattr(ops, name, fn)
            try:
                with_plain, cache_p = model.prefill(toks, T)
            finally:
                for name, fn in saved.items():
                    setattr(ops, name, fn)
        torch.cuda.synchronize()
        V = cfg.vocab
        werr = (with_kernel[..., :V] - with_plain[..., :V]).abs().max().item()
        check(bool(torch.isfinite(with_kernel).all()) and werr <= 1e-3,
              f"{arch} {layers}-layer f32 prefill logits: kernels vs plain max "
              f"abs err {werr:.3e} > 1e-3")
        herr = max([(ck["h"] - cp["h"]).abs().max().item()
                    for ck, cp in zip(cache_k, cache_p) if "h" in ck], default=0.0)
        check(herr <= 1e-3, f"{arch}: recurrent state kernels vs plain max abs "
              f"err {herr:.3e} > 1e-3")
        details.append(f"{arch} {layers}L T={T} logits {werr:.3e}"
                       + (f" state {herr:.3e}" if cfg.pattern != ("attn",) else ""))
        del model, with_kernel, with_plain, cache_k, cache_p
        free()
    phase(4, "whole models kernels against plain", "f32 B=1, max abs err: "
          + "; ".join(details))

    # -- 5. main paths --------------------------------------------------------
    launches = {}
    for arch, argv in MAIN_PATHS:
        for m in kernels.values():
            m.LAUNCHES = 0
        res = serve.run(argv)
        counts = {name: m.LAUNCHES for name, m in kernels.items()}
        launches[arch] = counts
        cfg = res.cfg
        types = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
        want = {"flash_attention": sum(t in ("attn", "local") for t in types),
                "ssm_scan": types.count("mamba"),
                "rglru_scan": types.count("rglru")}
        check(counts == want, f"{arch}: kernel launches {counts} in the main "
              f"path, expected one per layer of its type in prefill {want}")
        B, steps = int(argv[argv.index("--batch") + 1]), int(argv[argv.index("--steps") + 1])
        check(tuple(res.tokens.shape) == (B, steps),
              f"{arch}: tokens {tuple(res.tokens.shape)}")
        check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()),
              f"{arch}: generated token outside [0, vocab)")
        check(all(bool(torch.isfinite(lg).all()) for lg in res.logits),
              f"{arch}: non-finite logits on the main path")
        phase(5, f"main path {arch}",
              f"{cfg.n_layers} layers {str(cfg.dtype).removeprefix('torch.')} "
              f"B={B} prompt "
              f"{argv[argv.index('--prompt-len') + 1]} decode {steps}: prefill "
              f"{res.prefill_ms:.3f} ms, decode {res.decode_ms_per_step:.3f} "
              f"ms/step, {res.decode_tok_s:.1f} tok/s; launches {counts}")
        del res
        free()

    # -- 6. times at the main-path shapes ---------------------------------------
    def flash_times(shape):
        B, T, S, H, K, D, causal, window = shape
        q, k, v = attn_inputs(torch, shape, torch.bfloat16, seed=99)
        ms = time_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, causal=causal, window=window), iters=10)
        plain_ms = time_ms(torch, lambda: ref.attention_ref(
            q, k, v, causal=causal, window=window), iters=3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window > 0:
            qpos = torch.arange(T, device="cuda")[:, None] + (S - T)
            kpos = torch.arange(S, device="cuda")[None, :]
            mask = (kpos <= qpos) & (kpos > qpos - window)
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        library_ms = time_ms(torch, lib, iters=10)
        flops = 4 * D * visible_pairs(T, S, causal, window) * B * H
        b_ms, b_by, detail = bound(flops, PEAK_BF16_FLOPS, 0, nbytes(q, k, v, q))
        del q, k, v, qt, kt, vt
        free()
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=library_ms), (
            f"flash_attention bf16 {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"by {b_by} ({detail}; f32 CUDA-core bound "
            f"{flops / PEAK_F32_FLOPS * 1e3:.4f} ms)")

    times, lines = {}, []
    times["flash_attention"], line = flash_times(MAIN_SHAPE)
    lines.append(line)
    times["flash_local"], line = flash_times(LOCAL_SHAPE)
    lines.append(line)

    args = ssm_inputs(torch, SSM_MAIN, torch.bfloat16, seed=98)
    Bt, T, I, N, _ = SSM_MAIN
    ms = time_ms(torch, lambda: ss.ssm_scan_cuda(*args), iters=20)
    plain_ms = time_ms(torch, lambda: ref.ssm_scan_ref(*args), iters=2, warmup=1)
    y, hT = ss.ssm_scan_cuda(*args)
    # per (b,t,i,n): dt*A, dt*x*B, the h FMA, the y FMA = 6 flops and one exp;
    # per (b,t,i): dt*x and D*x + y = 3 flops.
    b_ms, b_by, detail = bound(Bt * T * I * (6 * N + 3), PEAK_F32_FLOPS,
                               Bt * T * I * N, nbytes(*args, y, hT))
    times["ssm_scan"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None)
    lines.append(f"ssm_scan x bf16 {SSM_MAIN[:4]}: kernel {ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({detail}); "
                 "no library call computes a selective scan")
    del args, y, hT
    free()

    args = rglru_inputs(torch, RGLRU_MAIN, torch.bfloat16, seed=97)
    B, T, L, _ = RGLRU_MAIN
    ms = time_ms(torch, lambda: rs.rglru_scan_cuda(*args), iters=20)
    plain_ms = time_ms(torch, lambda: ref.rglru_ref(*args), iters=2, warmup=1)
    hs, hT = rs.rglru_scan_cuda(*args)
    # per element: 2 sigmoids (4 exp/reciprocal), exp(log_a), exp(2 log_a),
    # sqrt = 7 special-function ops; about 12 flops around them.
    b_ms, b_by, detail = bound(B * T * L * 12, PEAK_F32_FLOPS, B * T * L * 7,
                               nbytes(*args, hs, hT))
    times["rglru_scan"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None)
    lines.append(f"rglru_scan bf16 {RGLRU_MAIN[:3]}: kernel {ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({detail}); "
                 "no library call computes an RG-LRU")
    del args, hs, hT
    free()
    phase(6, "times", " | ".join(lines))

    # -- 7. kernels line and result -------------------------------------------
    errs = {"flash_attention": main_err[("flash_attention", MAIN_SHAPE)],
            "ssm_scan": main_err["ssm_scan"], "rglru_scan": main_err["rglru_scan"]}
    line = []
    for name, m in kernels.items():
        by_path = {arch: counts[name] for arch, counts in launches.items()}
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/" + m.SOURCE,
                 "replaces": m.REPLACES, "launches": sum(by_path.values()),
                 "max_abs_err": errs[name], **times[name],
                 "launches_by_path": by_path}
        if name == "flash_attention":
            entry["at_recurrentgemma_local"] = dict(
                shape=list(LOCAL_SHAPE),
                max_abs_err=main_err[("flash_attention", LOCAL_SHAPE)],
                **times["flash_local"])
        line.append(entry)
    print(smi_line, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

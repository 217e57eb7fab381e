#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits nonzero
without the final result line:

1. Device: the card's name and power limit, from nvidia-smi.
2. Build: every CUDA kernel of the serving and training paths (flash
   attention forward and backward, the selective scan, the RG-LRU, int8
   quantization), compiled from the sources under
   src/repro_torch/kernels/csrc with one nvcc per source, all started
   together.
3. Kernel against plain: each kernel's wrapper against its plain PyTorch
   version on the card, over the reference's kernel test cases, cases
   beyond them (an initial state, T not a multiple of the time tile,
   channels not a multiple of the block, rows that see no key, rounding
   ties, a row of zeros; head dim 256 and the backward's GQA group splits
   on the tensor cores; the chunked scans' edges: T of one step, a segment
   less one, a chunk, a chunk plus 3 and two chunks plus 17, ragged channel
   blocks on the cp.async and the plain-load routes, N in {1, 5, 12, 16})
   and the main-path shapes, in f32 and bf16.
   Tolerances: f32 atol/rtol 1e-4, bf16 outputs 2e-2, the scans' f32 final
   states 1e-4; the flash forward's log-sum-exp (written for the backward)
   against a plain logsumexp at 1e-4, with its output bit-identical to the
   forward without it; the flash backward's dQ, dK, dV against autograd of
   the plain attention at the same f32 / bf16 tolerances, and bit for bit
   equal on a second call, as are both scans at their main shapes;
   quantization's int8 codes exactly equal and its
   scales within 1e-6.  The flash kernels' path queries must put the bf16
   main shapes (qwen3, recurrentgemma-local and starcoder2 forward,
   starcoder2 backward) on the tensor cores and f32 on the FMA kernels,
   and the backward's group split must be the one each case expects.
4. Whole models at full width, f32, kernels against plain (atol 1e-3 on
   the last-position logits): qwen3-32b 2 layers, B=1, T=256;
   falcon-mamba-7b 2 layers, B=1, T=256; recurrentgemma-9b 3 layers (one
   rglru, rglru, local super-block), B=1, T=2100, past its 2048 window.
   Then one starcoder2-3b train step (2 layers, B=2, T=256, AdamW lr 3e-4)
   with the flash kernels against the same step on plain attention: loss,
   grad norm and every updated parameter within 1e-3, and each leaf's
   gradient, read from its first moment ((1-b1) * clip * g after one step
   from zero), within 1e-3 of that leaf's norm; and the step with 2
   microbatches against 1 on the card, held to the same checks.
5. Main paths, with every kernel's launch count set to 0 just before each
   run and read just after.  ``repro_torch.launch.serve`` at full width,
   bf16, batch 4, 32 greedy decode steps: qwen3-32b 8 layers, prompt 1024
   (flash 8); falcon-mamba-7b 8 layers, prompt 1024 (ssm 8);
   recurrentgemma-9b 8 layers, prompt 3000 (rglru 6, flash 2).
   ``repro_torch.launch.train`` for starcoder2-3b at full width, 8 layers,
   bf16, B=4, T=1024, 3 steps on fresh batches: with remat, 16 flash
   forward and 8 flash backward launches per step; the loss is finite.
   The trained state then takes 3 more steps of the same train step on one
   batch, where the loss must fall (the reference's memorization check,
   tests/test_train.py).  Then the gradients of one more loss go through
   one error-feedback int8 round (``train.grad_compress.ef_round``) leaf
   by leaf, one quantize launch per leaf: each leaf's codes must equal the
   plain quantization's of ``g + err`` exactly and its scales within 1e-6,
   ``decompress + new_err`` must give back ``g + err`` (relative 1e-6), and
   ``|new_err| <= scale/2`` on every row (up to the f32 rounding of
   x/scale and q*scale, 2**-15 of the scale).
   Then checkpoint/restart through BaseFS: ``launch.train`` at the same
   shape with ``--steps 4 --ckpt-every 2 --fail-at 3 --consistency session
   --ckpt-hosts 4`` saves after steps 2 and 4 and, after step 3, restores
   step 2's checkpoint on 3 hosts with host 1's rows from its partner copy
   and runs step 3 again: 5 steps executed, flash forward 80 and backward
   40 launches, every loss finite and step 3's loss after the restart equal
   to its loss before.  Step 4's checkpoint, restored the same way, must
   equal the final state bit for bit on the card.  That state is then saved
   under commit and under session (4 hosts, partner copies) and restored on
   3 with host 1 failed, bit for bit; commit's restore must make more than
   4x session's query RPCs (the paper's Fig. 5 gap).  Printed: each save's
   and restore's host wall time, the bytes BaseFS moved, the process's
   host RSS now and at its peak after each step, and the save and
   restore times that
   ``CostModel().replay`` models on its own hardware constants (modelled,
   not measured on the card).
   Then ingest: 64 samples of 1025 tokens from ``make_token_samples``,
   preloaded by a ``PreloadedStore`` on 4 hosts, feed starcoder2-3b at the
   same shape through ``TokenPipeline``: 6 steps from epoch 0 and 2 from
   epoch 1, from one seeded state, once under commit and once under
   session.  Every batch must be the samples in ``epoch_assignment``'s
   order bit for bit (labels their roll), epoch 1's order must differ from
   epoch 0's, the two runs must see bit-equal batches and give equal
   losses, and each run launches flash forward 128 and backward 64.
   Printed: losses, step ms, TokenPipeline host ms per batch, query RPCs,
   BaseFS bytes and the DES's modelled time of the reads.  Last, the
   ``repro_torch.examples.train_checkpoint`` twin at ``--steps 40
   --ckpt-every 10``: 40 steps with a host failure after step 20 and an
   elastic restart from its checkpoint, flash 960 / 480, finite and falling
   losses, and step 40's checkpoint restored bit-equal.
6. Times at the main-path shapes: kernel, plain version, the least time
   the card could take (bound, from the bytes moved and the operations
   done) and one PyTorch library call as a yardstick where one computes
   the same function (the port never calls it); each flash line names the
   path it took, and each scan line the time of the scan kernel it
   replaced (one thread per channel walking all T).
7. The ``kernels`` JSON line (the scans' entries with their tile sizes),
   then the result line
   ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

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
# on both paths of the kernels (bf16 with D in {16, 32, 64, 128, 256} runs
# the forward on the tensor cores, and D in {16, 32, 64, 128} the backward;
# f32 and other head dims run on the CUDA cores).
EXTRA_CASES = [
    (1, 40, 40, 4, 2, 256, True, 16),
    (2, 24, 8, 4, 2, 64, True, 0),
    (1, 33, 70, 8, 1, 128, False, 0),
    (1, 100, 100, 4, 2, 128, True, 24),
    (2, 65, 130, 8, 2, 64, True, 0),
    (1, 70, 70, 4, 4, 32, False, 0),
    (1, 50, 50, 2, 1, 96, True, 0),
]
# Head dim 256: T ragged against the 64-row query tile and the 32-key KV
# tile, rows that see no key (T > S), non-causal T != S, a window that
# empties whole KV tiles, suffix queries; H/K in {1, 2, 16}.
D256_CASES = [
    (1, 100, 100, 2, 2, 256, True, 0),
    (2, 40, 24, 4, 2, 256, True, 0),
    (1, 33, 90, 16, 1, 256, False, 0),
    (1, 300, 300, 16, 1, 256, True, 64),
    (1, 130, 200, 4, 2, 256, True, 48),
]
# The tensor-core backward's GQA group splits: case -> the number of groups
# G its dK/dV pass splits a KV head's H/K query heads into.  Group sizes 1,
# 3 and 12; G = 2 over a group of 3, which it does not divide; ragged T and
# S, T > S, suffix queries, a window, non-causal T != S.
BWD_TC_GROUPS = {
    (1, 100, 100, 4, 4, 64, True, 0): 1,
    (2, 70, 90, 6, 2, 32, True, 0): 3,
    (1, 40, 24, 12, 4, 64, True, 0): 3,
    (1, 130, 130, 12, 1, 128, True, 48): 12,
    (1, 200, 150, 12, 1, 32, False, 0): 12,
    (4, 1024, 1024, 12, 4, 64, True, 0): 2,
}
MAIN_SHAPE = (4, 1024, 1024, 64, 8, 128, True, 0)      # qwen3-32b prefill, B=4
LOCAL_SHAPE = (4, 3000, 3000, 16, 1, 256, True, 2048)  # recurrentgemma local
TRAIN_SHAPE = (4, 1024, 1024, 24, 2, 128, True, 0)     # starcoder2-3b train, B=4
ALL_ATTN = (ATTN_CASES + EXTRA_CASES + D256_CASES + list(BWD_TC_GROUPS)
            + [MAIN_SHAPE, LOCAL_SHAPE, TRAIN_SHAPE])
BWD_TC_GROUPS[TRAIN_SHAPE] = 4
# Quantize: tests/test_kernels.py's shapes, a row of zeros, rows on exact .5
# ties, and the largest gradient leaf of the starcoder2-3b main path (the
# (3072, 12288) FFN matrix cut into 1024-wide rows by grad_compress._rows).
QUANT_CASES = [(8, 16), (7, 33), (128, 256), (1, 5), "zero-row", "ties"]
QUANT_MAIN = (36864, 1024)
# Bt, T, I, N, with h0 -- tests/test_kernels.py SSM_CASES, then an initial
# state, T past one tile (20, 1000), I not a multiple of a channel block;
# then the chunked kernel's edges (64-step chunks of 16-step segments,
# 64-channel blocks): T in {1, 15, 64, 67, 145, 200}, I a ragged block on the
# plain-load route (71, 33) and on the cp.async route (72, 80), N in {1, 5,
# 12, 16}; and the falcon-mamba-7b prefill shape.
SSM_CASES = [(1, 8, 4, 2, False), (2, 16, 8, 4, False), (1, 24, 6, 3, False),
             (2, 16, 8, 4, True), (2, 20, 200, 16, True),
             (1, 1000, 130, 16, False),
             (2, 145, 71, 16, True), (1, 1, 5, 1, False), (2, 15, 16, 5, True),
             (1, 64, 33, 16, False), (3, 67, 72, 5, True),
             (1, 200, 80, 12, True)]
SSM_MAIN = (4, 1024, 8192, 16, False)
# B, T, L, with h0 -- tests/test_kernels.py RGLRU_CASES, then T=20 (where the
# Pallas wrapper's unmasked padding breaks h_T), T=1000 with L not a multiple
# of the 64-channel block; then the chunked kernel's edges (64-step chunks of
# 16-step segments): T in {1, 15, 64, 67, 145, 200}, L a ragged block on the
# plain-load route (71, 3) and on the cp.async route (72, 136); and the
# recurrentgemma-9b prefill shape.
RGLRU_CASES = [(1, 8, 4, False), (2, 16, 8, False), (1, 13, 6, False),
               (1, 20, 6, False), (2, 20, 6, True), (2, 1000, 100, True),
               (2, 145, 71, True), (1, 1, 3, False), (2, 15, 64, True),
               (1, 64, 100, False), (3, 67, 72, True), (1, 200, 136, False)]
RGLRU_MAIN = (4, 3000, 4096, False)
# The scans' times at their main shapes before the chunked kernels (one
# thread per channel walking all T): this script's phase 6 on an H100 80GB
# HBM3 at 700 W.  Printed as a reference point; that kernel is not rebuilt.
PREVIOUS_MS = {"ssm_scan": 0.7920, "rglru_scan": 0.7553}


def serve_args(arch: str, prompt: int) -> list:
    return ["--arch", arch, "--layers", "8", "--batch", "4", "--prompt-len",
            str(prompt), "--steps", "32", "--device", "cuda", "--seed", "0"]


MAIN_PATHS = [("qwen3-32b", serve_args("qwen3-32b", 1024)),
              ("falcon-mamba-7b", serve_args("falcon-mamba-7b", 1024)),
              ("recurrentgemma-9b", serve_args("recurrentgemma-9b", 3000))]
TRAIN_ARGS = ["--arch", "starcoder2-3b", "--layers", "8", "--batch", "4",
              "--seq", "1024", "--steps", "3", "--device", "cuda", "--seed", "0"]
MEMORIZE_STEPS = 3
# Checkpoint/restart: saves after steps 2 and 4, a host failure after step 3,
# an elastic restart from the step-2 checkpoint on 3 hosts, step 3 again.
CKPT_ARGS = ["--arch", "starcoder2-3b", "--layers", "8", "--batch", "4",
             "--seq", "1024", "--steps", "4", "--ckpt-every", "2", "--fail-at",
             "3", "--consistency", "session", "--ckpt-hosts", "4", "--device",
             "cuda", "--seed", "0"]
CKPT_EXECUTED = 5
# Ingest: 64 samples of T+1 = 1025 int32 tokens (4100 bytes each) preloaded
# on 4 hosts, 16 each; B=4 batches, 6 steps from epoch 0 and 2 from epoch 1.
INGEST_SAMPLES, INGEST_HOSTS, INGEST_BATCH, INGEST_SEQ = 64, 4, 4, 1024
INGEST_STEPS = ((0, 6), (1, 2))
# The reference's train_checkpoint example at its default widths (~100M
# params, f32, B=8, T=128): host 1 fails after step 20, the restart resumes
# from step 20's checkpoint on 3 hosts, 40 steps executed.
EXAMPLE_ARGS = ["--steps", "40", "--ckpt-every", "10", "--device", "cuda"]


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


def quant_input(torch, case, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if case == "zero-row":
        x = 3 * randn(torch, g, (4, 40))
        x[2] = 0.0
    elif case == "ties":
        # amax 127 and 254 give scales 1 and 2, so x/scale lands on .5 ties.
        h = torch.arange(64, device="cuda", dtype=torch.float32) % 8 - 3.5
        r1, r2 = h.clone(), 2 * h
        r1[0], r2[-1] = 127.0, -254.0
        x = torch.stack([r1, r2, -r1])
    else:
        x = 3 * randn(torch, g, case)
    return x.to(dtype)


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


def lse_plain(torch, q, k, causal: bool, window: int):
    """Each query row's log-sum-exp of its scaled, masked scores, (B,H,T)
    f32; -inf where a row sees no key."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // K, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * D ** -0.5
    qpos = torch.arange(T, device=q.device)[:, None] + (S - T)
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)


def state_leaves(state) -> dict:
    """Every tensor of a port train state, by a name of its own."""
    out = {f"params.{n}": p for n, p in state["params"].named_parameters()}
    for k in ("m", "v"):
        out.update({f"opt.{k}.{n}": t for n, t in state["opt"][k].items()})
    out["opt.step"], out["step"] = state["opt"]["step"], state["step"]
    return out


def check_bit_equal(torch, got, want, what) -> None:
    """Every leaf of train state ``got`` equals ``want``'s bit for bit, on
    the same device and in the same dtype."""
    g, w = state_leaves(got), state_leaves(want)
    check(g.keys() == w.keys(), f"{what}: leaves differ")
    for n, t in w.items():
        check(g[n].device == t.device and g[n].dtype == t.dtype
              and torch.equal(g[n], t), f"{what}: {n} differs from the saved state")


def host_rss() -> str:
    """This process's resident set now (VmRSS of /proc/self/status) and at
    its peak so far (ru_maxrss, KiB on Linux)."""
    with open("/proc/self/status") as f:
        now = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:"))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return f"{now * 1024 / 1e9:.3f} GB now, {peak * 1024 / 1e9:.3f} GB peak"


def ingest_run(torch, cfg, opt, model_name: str, samples, device,
               reset_counts, read_counts) -> dict:
    """Train ``cfg`` from a fresh seeded state on TokenPipeline batches that
    came through BaseFS and the ``model_name`` layer, INGEST_STEPS of them,
    with the kernels' launch counts reset just before the run and read just
    after.  Checks every batch against the samples in ``epoch_assignment``
    order, bit for bit, and its labels against the tokens' roll; the state
    is freed before it returns."""
    from repro_torch.core import CostModel, EventKind
    from repro_torch.data import PreloadedStore, TokenPipeline
    from repro_torch.launch.serve import sync
    from repro_torch.train.train_step import make_train_step, train_state_init

    B, T = INGEST_BATCH, INGEST_SEQ
    device = torch.device(device)
    store = PreloadedStore(model_name, num_hosts=INGEST_HOSTS,
                           samples_per_host=len(samples) // INGEST_HOSTS,
                           procs_per_host=1, samples=samples)
    store.preload()
    pipe = TokenPipeline(store, cfg, B, T, device=device)
    state = train_state_init(torch.Generator(device=device).manual_seed(0),
                             cfg, opt, device)
    step = make_train_step(cfg, opt, num_microbatches=cfg.microbatches)
    store.fs.ledger.mark_phase("ingest")
    q0 = store.fs.ledger.count(EventKind.RPC, "query")
    out = {"losses": [], "pipe_ms": [], "step_ms": [], "tokens": []}
    reset_counts()
    for epoch, n in INGEST_STEPS:
        flat = [i for sub in store.epoch_assignment(epoch) for i in sub]
        batches = pipe.batches(epoch)
        for k in range(n):
            sync(device)
            t0 = time.perf_counter()
            batch = next(batches)
            sync(device)
            out["pipe_ms"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            out["losses"].append(float(metrics["loss"]))
            sync(device)
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            want = np.stack([samples[i][:T] for i in flat[k * B:(k + 1) * B]])
            got = batch["tokens"].cpu()
            check(batch["tokens"].dtype == torch.int64
                  and batch["labels"].dtype == torch.int64
                  and np.array_equal(got.numpy(), want)
                  and torch.equal(batch["labels"].cpu(),
                                  torch.roll(got, -1, dims=1)),
                  f"ingest {model_name}: epoch {epoch} batch {k} is not the "
                  "samples of epoch_assignment's order, or its labels not "
                  "their roll")
            out["tokens"].append(got)
    out["counts"] = read_counts()
    del state, metrics, batch, step
    out["queries"] = store.fs.ledger.count(EventKind.RPC, "query") - q0
    out["des"] = {p.name: p for p in CostModel().replay(store.fs.ledger)}["ingest"]
    out["orders"] = [store.epoch_assignment(e) for e, _ in INGEST_STEPS]
    return out


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

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import CostModel, EventKind
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_launch
    from repro_torch.models.transformer import init_params
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.train import grad_compress as gc_
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (loss_fn, make_train_step,
                                              train_state_init)

    # name -> (module, its source attribute, its launch counter)
    kernels = {"flash_attention": (fa, "SOURCE", "LAUNCHES"),
               "flash_attention_bwd": (fa, "BWD_SOURCE", "BWD_LAUNCHES"),
               "ssm_scan": (ss, "SOURCE", "LAUNCHES"),
               "rglru_scan": (rs, "SOURCE", "LAUNCHES"),
               "quantize": (qz, "SOURCE", "LAUNCHES")}
    sources = [getattr(m, src) for m, src, _ in kernels.values()]

    def reset_counts():
        for m, _, counter in kernels.values():
            setattr(m, counter, 0)

    def read_counts():
        return {name: getattr(m, counter)
                for name, (m, _, counter) in kernels.items()}

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
    _build.load_all(sources)
    phase(2, "build", f"{', '.join(sources)} in "
          f"{time.perf_counter() - t0:.2f} s")

    # -- 3. kernels against plain ---------------------------------------------
    main_err, paths = {}, {}
    n_cases = 0
    with torch.inference_mode():
        for dtype, tol in tols.items():
            for i, case in enumerate(ALL_ATTN):
                causal, window = case[6], case[7]
                q, k, v = attn_inputs(torch, case, dtype, seed=i)
                got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
                path = fa.fwd_path(dtype, case[5], fa._aligned(q, k, v, got))
                check(dtype == torch.bfloat16 or path == 0,
                      f"flash_attention_cuda {case} f32: path {path}, not the FMA kernel")
                if dtype == torch.bfloat16 and case in (MAIN_SHAPE, LOCAL_SHAPE,
                                                        TRAIN_SHAPE):
                    check(path == 1, f"flash_attention_cuda {case} bf16: path "
                          f"{fa.PATHS[path]}, not the tensor cores")
                    paths[("flash_attention", case)] = path
                want = ref.attention_ref(q, k, v, causal=causal, window=window)
                err = compare(torch, got, want, tol, f"flash_attention_cuda {case} {dtype}")
                if dtype == torch.bfloat16 and case in (MAIN_SHAPE, LOCAL_SHAPE,
                                                        TRAIN_SHAPE):
                    main_err[("flash_attention", case)] = err
                # The forward as training calls it, writing the log-sum-exp.
                o, lse, _ = fa._forward(q, k, v, causal, window, case[5] ** -0.5,
                                        with_lse=True)
                check(torch.equal(o, got), f"flash_attention_cuda {case} {dtype}: "
                      "output with the log-sum-exp differs from without")
                lse_want = lse_plain(torch, q, k, causal, window)
                fin = torch.isfinite(lse_want)
                check(torch.equal(fin, torch.isfinite(lse)),
                      f"flash_attention_cuda lse {case} {dtype}: rows that see "
                      "no key differ from plain")
                lerr = compare(torch, lse[fin], lse_want[fin], 1e-4,
                               f"flash_attention_cuda lse {case} {dtype}")
                if dtype == torch.bfloat16 and case == TRAIN_SHAPE:
                    main_err["flash_lse"] = lerr
                n_cases += 1
                del q, k, v, got, want, o, lse, lse_want, fin
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
            for i, case in enumerate(QUANT_CASES + [QUANT_MAIN]):
                x = quant_input(torch, case, dtype, seed=300 + i)
                q, s = qz.quantize_cuda(x)
                q_ref, s_ref = ref.quantize_ref(x)
                diff = int((q != q_ref).sum())
                check(diff == 0, f"quantize_cuda {case} {dtype}: {diff} int8 "
                      "codes differ from plain")
                err = compare(torch, s, s_ref, 1e-6, f"quantize_cuda scale {case} {dtype}")
                if dtype == torch.float32 and case == QUANT_MAIN:
                    main_err["quantize"] = err
                n_cases += 1
                del x, q, s, q_ref, s_ref
                free()
    # The backward needs grad: autograd through the kernels against autograd
    # through the plain attention, on the same inputs and output gradient.
    # The plain side runs in f32 on the inputs' values: in bf16 its autograd
    # rounds each query head's dK/dV to bf16 before summing the GQA group,
    # which alone misses the f32 gradient by up to 0.06 (the kernel sums in
    # f32 and rounds once).
    for dtype, tol in tols.items():
        for i, case in enumerate(ALL_ATTN):
            B, T, S, H, K, D, causal, window = case
            q, k, v = (x.requires_grad_() for x in
                       attn_inputs(torch, case, dtype, seed=400 + i))
            dout = randn(torch, torch.Generator(device="cuda").manual_seed(500 + i),
                         q.shape, dtype)
            got = torch.autograd.grad(
                fa.flash_attention_cuda(q, k, v, causal=causal, window=window),
                (q, k, v), dout)
            path = fa.bwd_path(dtype, D, fa._aligned(q, k, v, dout))
            check(dtype == torch.bfloat16 or path == 0,
                  f"flash_attention backward {case} f32: path {path}, not the "
                  "FMA kernels")
            if dtype == torch.bfloat16 and case in BWD_TC_GROUPS:
                check(path == 1 and fa.bwd_groups(B, S, H, K) == BWD_TC_GROUPS[case],
                      f"flash_attention backward {case} bf16: path "
                      f"{fa.PATHS[path]}, {fa.bwd_groups(B, S, H, K)} groups; "
                      f"expected the tensor cores, {BWD_TC_GROUPS[case]} groups")
            if dtype == torch.bfloat16 and case == TRAIN_SHAPE:
                paths["flash_attention_bwd"] = path
            qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
            want = torch.autograd.grad(
                ref.attention_ref(qf, kf, vf, causal=causal, window=window),
                (qf, kf, vf), dout.float())
            errs = [compare(torch, g, w, tol,
                            f"flash_attention backward d{name} {case} {dtype}")
                    for name, g, w in zip("qkv", got, want)]
            if dtype == torch.bfloat16 and case == TRAIN_SHAPE:
                main_err["flash_attention_bwd"] = max(errs)
            n_cases += 1
            del q, k, v, qf, kf, vf, dout, got, want
            free()
    # The backward is deterministic: a second call gives the same bits (G=4
    # at the training shape, G=2 over a group of 3).
    for i, case in enumerate((TRAIN_SHAPE, (4, 1024, 1024, 12, 4, 64, True, 0))):
        B, T, S, H, K, D, causal, window = case
        q, k, v = attn_inputs(torch, case, torch.bfloat16, seed=600 + i)
        dout = randn(torch, torch.Generator(device="cuda").manual_seed(700 + i),
                     q.shape, torch.bfloat16)
        with torch.no_grad():
            o, lse, o_lo = fa._forward(q, k, v, causal, window, D ** -0.5,
                                       with_lse=True)
            first, second = (fa.flash_attention_bwd_cuda(
                q, k, v, o, lse, dout, causal=causal, window=window, o_lo=o_lo)
                for _ in range(2))
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"flash_attention backward {case} bf16: two calls differ")
        n_cases += 1
        del q, k, v, dout, o, lse, o_lo, first, second
        free()
    # The scans' order is fixed: a second call at the main shapes gives the
    # same bits.
    with torch.inference_mode():
        for name, run, inputs, case in (
                ("ssm_scan", ss.ssm_scan_cuda, ssm_inputs, SSM_MAIN),
                ("rglru_scan", rs.rglru_scan_cuda, rglru_inputs, RGLRU_MAIN)):
            args = inputs(torch, case, torch.bfloat16, seed=800)
            first, second = run(*args), run(*args)
            check(all(torch.equal(a, b) for a, b in zip(first, second)),
                  f"{name} {case} bf16: two calls differ")
            n_cases += 1
            del args, first, second
            free()
    path_line = ", ".join(
        f"{name} {fa.PATHS[p]}" for name, p in (
            ("qwen3 forward", paths[("flash_attention", MAIN_SHAPE)]),
            ("recurrentgemma-local forward", paths[("flash_attention", LOCAL_SHAPE)]),
            ("starcoder2 forward", paths[("flash_attention", TRAIN_SHAPE)]),
            ("starcoder2 backward", paths["flash_attention_bwd"])))
    phase(3, "kernels against plain",
          f"{n_cases} cases; paths (bf16): {path_line}; f32 on the FMA "
          "kernels; flash backward and both scans deterministic (4 cases "
          "bitwise equal); "
          "main-path max abs err: flash qwen3 bf16 "
          f"{main_err[('flash_attention', MAIN_SHAPE)]:.3e}, flash local bf16 "
          f"{main_err[('flash_attention', LOCAL_SHAPE)]:.3e}, flash starcoder2 "
          f"bf16 {main_err[('flash_attention', TRAIN_SHAPE)]:.3e} (its lse "
          f"{main_err['flash_lse']:.3e}), ssm bf16 "
          f"{main_err['ssm_scan']:.3e}, rglru bf16 {main_err['rglru_scan']:.3e}, "
          f"flash backward starcoder2 bf16 {main_err['flash_attention_bwd']:.3e} "
          "(against f32 autograd of plain), "
          f"quantize scales f32 {main_err['quantize']:.3e} (codes equal)")

    # -- 4. whole models at full width, kernels against plain -----------------
    plain = {"flash_attention": ref.attention_ref, "ssm_scan": ref.ssm_scan_ref,
             "rglru": ref.rglru_ref}

    def on_plain(fn):
        """fn() with ops' kernel entry points swapped for the plain versions."""
        saved = {name: getattr(ops, name) for name in plain}
        for name, f in plain.items():
            setattr(ops, name, f)
        try:
            return fn()
        finally:
            for name, f in saved.items():
                setattr(ops, name, f)

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
            with_plain, cache_p = on_plain(lambda: model.prefill(toks, T))
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

    # One train step: with the flash kernels (forward and backward) against
    # the same step on plain attention, then M=2 against M=1 on the kernels.
    cfg = dataclasses.replace(get_config("starcoder2-3b"), n_layers=2,
                              dtype=torch.float32)
    opt = AdamWConfig()

    def fresh_state():
        return train_state_init(torch.Generator(device="cuda").manual_seed(3),
                                cfg, opt, "cuda")

    batch = synthetic_batch(4, cfg, 2, 256, "cuda")
    step1 = make_train_step(cfg, opt, num_microbatches=1)
    runs = {"kernels": step1(fresh_state(), batch),
            "plain": on_plain(lambda: step1(fresh_state(), batch)),
            "M=2": make_train_step(cfg, opt, num_microbatches=2)(fresh_state(), batch)}
    (sk, mk) = runs.pop("kernels")
    pk = dict(sk["params"].named_parameters())
    train_errs = {}
    for name, (so, mo) in runs.items():
        for key in ("loss", "grad_norm"):
            a, b = float(mk[key]), float(mo[key])
            check(abs(a - b) <= 1e-3, f"starcoder2 train step, kernels vs "
                  f"{name}: {key} {b} vs {a}")
        perr = max((p - pk[n]).abs().max().item()
                   for n, p in so["params"].named_parameters())
        check(perr <= 1e-3, f"starcoder2 train step, kernels vs {name}: updated "
              f"parameters differ by {perr:.3e} > 1e-3")
        # A first AdamW step moves each weight by about lr * sign(g) whatever
        # |g| is, so the gradients are held leaf by leaf, through the first
        # moments: m = (1 - b1) * clip * g after one step from zero.
        gerr = 0.0
        for n, m in so["opt"]["m"].items():
            rel = ((m - sk["opt"]["m"][n]).norm() / m.norm().clamp(min=1e-30)).item()
            check(rel <= 1e-3, f"starcoder2 train step, kernels vs {name}: "
                  f"gradient of {n} misses by {rel:.3e} of its norm")
            gerr = max(gerr, rel)
        train_errs[name] = (abs(float(mk["loss"]) - float(mo["loss"])), perr, gerr)
    details.append(
        f"starcoder2-3b 2L train step B=2 T=256: loss {float(mk['loss']):.5f}, "
        f"kernels vs plain loss {train_errs['plain'][0]:.3e} params "
        f"{train_errs['plain'][1]:.3e} gradients (relative, per leaf) "
        f"{train_errs['plain'][2]:.3e}; M=2 vs M=1 loss {train_errs['M=2'][0]:.3e} "
        f"params {train_errs['M=2'][1]:.3e} gradients {train_errs['M=2'][2]:.3e}")
    del sk, mk, pk, runs, batch
    free()
    phase(4, "whole models kernels against plain", "f32, max abs err: "
          + "; ".join(details))

    # -- 5. main paths --------------------------------------------------------
    launches = {}
    for arch, argv in MAIN_PATHS:
        reset_counts()
        res = serve.run(argv)
        counts = read_counts()
        launches[arch] = counts
        cfg = res.cfg
        types = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
        want = {"flash_attention": sum(t in ("attn", "local") for t in types),
                "flash_attention_bwd": 0,
                "ssm_scan": types.count("mamba"),
                "rglru_scan": types.count("rglru"), "quantize": 0}
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

    # Training: launch.train's own function, then one error-feedback int8
    # round over the gradients of one more loss on the trained state.
    reset_counts()
    tr = train_launch.run(TRAIN_ARGS)
    counts = read_counts()
    launches["starcoder2-3b train"] = counts
    cfg, n_steps = tr.cfg, len(tr.losses)
    want = {"flash_attention": 2 * cfg.n_layers * n_steps,
            "flash_attention_bwd": cfg.n_layers * n_steps,
            "ssm_scan": 0, "rglru_scan": 0, "quantize": 0}
    check(counts == want, f"starcoder2-3b train: kernel launches {counts}, "
          f"expected {want} (with remat, two forwards and one backward per "
          "layer and step)")
    check(all(math.isfinite(x) for x in tr.losses),
          f"starcoder2-3b train: losses {tr.losses} not finite")
    phase(5, "main path starcoder2-3b train",
          f"{cfg.n_layers} layers {str(cfg.dtype).removeprefix('torch.')} "
          f"B=4 T=1024, {n_steps} steps on fresh batches: losses "
          f"{', '.join(f'{x:.4f}' for x in tr.losses)}; step ms "
          f"{', '.join(f'{x:.3f}' for x in tr.step_ms)}; "
          f"{tr.tokens_per_s:.1f} tokens/s over steps 2..{n_steps}; peak "
          f"{tr.peak_bytes / 1e9:.3f} GB; launches {counts}")

    # The trained state goes on through the same train step on one batch.
    reset_counts()
    step = make_train_step(cfg, tr.opt)
    one = synthetic_batch(12, cfg, 4, 1024, "cuda")
    state, mem_losses = tr.state, []
    for _ in range(MEMORIZE_STEPS):
        state, metrics = step(state, one)
        mem_losses.append(float(metrics["loss"]))
    counts = read_counts()
    launches["starcoder2-3b memorize"] = counts
    want = {"flash_attention": 2 * cfg.n_layers * MEMORIZE_STEPS,
            "flash_attention_bwd": cfg.n_layers * MEMORIZE_STEPS,
            "ssm_scan": 0, "rglru_scan": 0, "quantize": 0}
    check(counts == want, f"starcoder2-3b memorize: kernel launches {counts}, "
          f"expected {want}")
    check(all(math.isfinite(x) for x in mem_losses)
          and mem_losses[-1] < mem_losses[0],
          f"starcoder2-3b memorize: losses {mem_losses} not finite and falling")
    phase(5, "main path starcoder2-3b memorize one batch",
          f"{MEMORIZE_STEPS} more steps of the trained state on one batch: "
          f"losses {', '.join(f'{x:.4f}' for x in mem_losses)}; launches {counts}")
    del one, state, metrics

    reset_counts()
    model = tr.state["params"]
    params = dict(model.named_parameters())
    loss, _ = loss_fn(model, synthetic_batch(11, cfg, 4, 1024, "cuda"), cfg)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    del loss
    errs = gc_.ef_init(params)
    worst_sum, worst_err, worst_scale = 0.0, 0.0, 0.0
    for name, g in grads.items():
        q, s, ghat, new_err = gc_.ef_round(g, errs[name])
        check(ghat.dtype == g.dtype and ghat.shape == g.shape,
              f"ef_round {name}: ghat {ghat.dtype} {tuple(ghat.shape)}")
        target = g.float() + errs[name]
        # The kernel on this leaf against the plain quantization.
        q_ref, s_ref = ref.quantize_ref(gc_._rows(target))
        diff = int((q != q_ref).sum())
        check(diff == 0, f"ef_round {name}: {diff} int8 codes differ from plain")
        worst_scale = max(worst_scale, compare(torch, s, s_ref, 1e-6,
                                               f"ef_round {name} scales"))
        back = gc_.decompress(q, s, g.shape, torch.float32) + new_err
        rel = ((back - target).abs() / target.abs().clamp(min=1e-30)).max().item()
        check(rel <= 1e-6, f"ef_round {name}: decompress + new_err misses "
              f"g + err by {rel:.3e} relative")
        # Half a scale, plus the f32 rounding of x/scale and of q*scale for
        # |q| <= 127: 2 * 127.5 * 2**-24 < 2**-15 of the scale.
        ratio = (gc_._rows(new_err).abs() / s).max().item()
        check(ratio <= 0.5 + 2 ** -15, f"ef_round {name}: |new_err| reaches "
              f"{ratio:.7f} of its row's scale, more than 1/2")
        worst_sum, worst_err = max(worst_sum, rel), max(worst_err, ratio)
        del q, s, ghat, new_err, target, back, q_ref, s_ref
    counts = read_counts()
    launches["starcoder2-3b ef_round"] = counts
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers,
            "ssm_scan": 0, "rglru_scan": 0, "quantize": len(grads)}
    check(counts == want, f"starcoder2-3b loss backward + ef_round: launches "
          f"{counts}, expected {want}")
    phase(5, "main path starcoder2-3b gradient compression",
          f"ef_round over {len(grads)} gradient leaves: codes equal plain, "
          f"scales max abs err {worst_scale:.3e}; decompress + new_err "
          f"vs g + err max rel err {worst_sum:.3e}; max |new_err| / scale "
          f"{worst_err:.7f}; launches {counts}")
    del tr, model, params, grads, errs
    free()

    # Checkpoint/restart through BaseFS: launch.train's own function with a
    # host failure after step 3 and an elastic restart from step 2's
    # checkpoint on 3 hosts, host 1's rows from its partner copy.
    rss = {"before the checkpoint steps": host_rss()}
    reset_counts()
    ck = train_launch.run(CKPT_ARGS)
    counts = read_counts()
    launches["starcoder2-3b checkpoint/restart"] = counts
    rss["after the launcher's run"] = host_rss()
    cfg = ck.cfg
    check(ck.ckpt_steps == [2, 4] and ck.replayed == [3]
          and len(ck.losses) == CKPT_EXECUTED,
          f"starcoder2-3b checkpoint/restart: saves at {ck.ckpt_steps}, steps "
          f"replayed {ck.replayed}, {len(ck.losses)} steps executed; expected "
          f"saves at [2, 4], step 3 replayed, {CKPT_EXECUTED} steps")
    want = {"flash_attention": 2 * cfg.n_layers * CKPT_EXECUTED,
            "flash_attention_bwd": cfg.n_layers * CKPT_EXECUTED,
            "ssm_scan": 0, "rglru_scan": 0, "quantize": 0}
    check(counts == want, f"starcoder2-3b checkpoint/restart: kernel launches "
          f"{counts}, expected {want}")
    check(all(math.isfinite(x) for x in ck.losses),
          f"starcoder2-3b checkpoint/restart: losses {ck.losses} not finite")
    check(ck.losses[3] == ck.losses[2],
          f"starcoder2-3b checkpoint/restart: step 3's loss after the restart "
          f"{ck.losses[3]!r} differs from before the failure {ck.losses[2]!r}")
    # The final state is step 4's checkpoint: restore it elastically and hold
    # it against the live state on the card, bit for bit.
    t0 = time.perf_counter()
    again = ck.ckpt.restore(4, ck.state, num_hosts_new=3, failed_hosts=[1])
    torch.cuda.synchronize()
    verify_ms = (time.perf_counter() - t0) * 1e3
    check_bit_equal(torch, again, ck.state, "starcoder2-3b checkpoint 4")
    state_gb = sum(t.numel() * t.element_size()
                   for t in state_leaves(ck.state).values()) / 1e9
    phase(5, "main path starcoder2-3b checkpoint/restart",
          f"{cfg.n_layers} layers B=4 T=1024, --ckpt-every 2 --fail-at 3 "
          f"--consistency session --ckpt-hosts 4: losses "
          f"{', '.join(f'{x:.4f}' for x in ck.losses)} (step 3 before and "
          f"after the restart equal); saves at steps {ck.ckpt_steps} "
          f"{', '.join(f'{x:.1f}' for x in ck.save_ms)} ms, restore "
          f"{ck.restore_ms[0]:.1f} ms, {state_gb:.3f} GB of state; step 4's "
          f"checkpoint restored on 3 hosts bit-equal on the card in "
          f"{verify_ms:.1f} ms; launches {counts}")

    # The trained state under commit and under session: save on 4 hosts with
    # partner copies, restore on 3 with host 1 failed, bit for bit; the
    # restore's query RPCs are the paper's Fig. 5 gap on real state.
    state = ck.state
    del ck, again
    free()
    rss["with the launcher's checkpoints dropped"] = host_rss()
    ckpt_lines, queries = [], {}
    for model_name in ("commit", "session"):
        mgr = CheckpointManager(model=model_name, num_hosts=4, partner=True)
        t0 = time.perf_counter()
        mgr.save(0, state)
        save_ms = (time.perf_counter() - t0) * 1e3
        q0 = mgr.fs.ledger.count(EventKind.RPC, "query")
        t0 = time.perf_counter()
        out = mgr.restore(0, state, num_hosts_new=3, failed_hosts=[1])
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        queries[model_name] = mgr.fs.ledger.count(EventKind.RPC, "query") - q0
        check_bit_equal(torch, out, state, f"starcoder2-3b {model_name} restore")
        del out
        des = {p.name: p for p in CostModel().replay(mgr.fs.ledger)}
        save_p, restore_p = des["ckpt_save_0"], des["ckpt_restore_0"]
        ckpt_lines.append(
            f"{model_name}: save {save_ms:.1f} ms, restore {restore_ms:.1f} ms "
            f"(host wall time); BaseFS moved "
            f"{sum(save_p.bytes_by_kind.values()) / 1e9:.3f} GB in the save "
            f"and {sum(restore_p.bytes_by_kind.values()) / 1e9:.3f} GB in "
            f"the restore; restore query RPCs {queries[model_name]}; modelled "
            f"by the DES on its own hardware constants, not measured on the "
            f"card: save {save_p.duration:.4f} s, restore "
            f"{restore_p.duration:.4f} s")
        del mgr, des, save_p, restore_p
        free()
        rss[f"after {model_name}"] = host_rss()
    check(queries["commit"] > 4 * queries["session"],
          f"restore query RPCs: commit {queries['commit']} not above 4x "
          f"session {queries['session']}")
    phase(5, "main path starcoder2-3b checkpoint under commit and session",
          f"{state_gb:.3f} GB of state, 4 hosts with partner copies, restored "
          f"on 3 with host 1 failed, bit-equal: {'; '.join(ckpt_lines)}; host "
          "RSS of this process: "
          + "; ".join(f"{k} {v}" for k, v in rss.items()))
    del state
    free()

    # Ingest: starcoder2-3b at the training shape from TokenPipeline batches
    # that came through BaseFS and a consistency layer, once under commit and
    # once under session, each from the same seeded state.
    from repro_torch.data.pipeline import make_token_samples
    from repro_torch.examples import train_checkpoint as example

    cfg = dataclasses.replace(get_config("starcoder2-3b"), n_layers=8)
    opt = AdamWConfig(lr=1e-3, state_dtype=cfg.opt_state_dtype)
    samples = make_token_samples(0, INGEST_SAMPLES, INGEST_SEQ + 1, cfg.vocab)
    n_steps = sum(n for _, n in INGEST_STEPS)
    want = {"flash_attention": 2 * cfg.n_layers * n_steps,
            "flash_attention_bwd": cfg.n_layers * n_steps,
            "ssm_scan": 0, "rglru_scan": 0, "quantize": 0}
    runs = {}
    for model_name in ("commit", "session"):
        r = ingest_run(torch, cfg, opt, model_name, samples, "cuda",
                       reset_counts, read_counts)
        free()
        runs[model_name] = r
        launches[f"starcoder2-3b ingest {model_name}"] = r["counts"]
        check(r["counts"] == want, f"ingest {model_name}: kernel launches "
              f"{r['counts']}, expected {want}")
        check(all(math.isfinite(x) for x in r["losses"]),
              f"ingest {model_name}: losses {r['losses']} not finite")
        order0, order1 = r["orders"]
        check(order0 != order1, f"ingest {model_name}: epoch 1 deals the "
              "samples in epoch 0's order")
        des = r["des"]
        phase(5, f"main path starcoder2-3b ingest {model_name}",
              f"{cfg.n_layers} layers B={INGEST_BATCH} T={INGEST_SEQ}, "
              f"{INGEST_SAMPLES} samples of {INGEST_SEQ + 1} tokens on "
              f"{INGEST_HOSTS} hosts, steps {INGEST_STEPS} (epoch, steps), "
              f"every batch the samples of epoch_assignment's order: losses "
              f"{', '.join(f'{x:.4f}' for x in r['losses'])}; step ms "
              f"{', '.join(f'{x:.3f}' for x in r['step_ms'])}; TokenPipeline "
              f"host ms per batch {', '.join(f'{x:.3f}' for x in r['pipe_ms'])}"
              f"; query RPCs {r['queries']}; BaseFS bytes "
              f"{sum(des.bytes_by_kind.values())} in {des.rpc_count} RPCs; "
              f"modelled by the DES on its own hardware constants, not "
              f"measured on the card: {des.duration * 1e3:.4f} ms; launches "
              f"{r['counts']}")
    check(all(torch.equal(a, b) for a, b in
              zip(runs["commit"]["tokens"], runs["session"]["tokens"])),
          "ingest: commit and session saw different batches")
    check(runs["commit"]["losses"] == runs["session"]["losses"],
          f"ingest: losses differ between commit {runs['commit']['losses']} "
          f"and session {runs['session']['losses']}")
    phase(5, "main path starcoder2-3b ingest commit against session",
          f"batches bit-equal and losses equal; query RPCs commit "
          f"{runs['commit']['queries']}, session {runs['session']['queries']}")
    del runs, samples

    # The train_checkpoint example on the card: ingest -> train -> checkpoint
    # through one BaseFS, host 1's failure after step 20 and an elastic
    # restart from step 20's checkpoint on 3 hosts.
    reset_counts()
    t0 = time.perf_counter()
    ex = example.main(EXAMPLE_ARGS)
    ex_s = time.perf_counter() - t0
    counts = read_counts()
    launches["train_checkpoint example"] = counts
    cfg, executed = ex.cfg, len(ex.losses)
    want = {"flash_attention": 2 * cfg.n_layers * executed,
            "flash_attention_bwd": cfg.n_layers * executed,
            "ssm_scan": 0, "rglru_scan": 0, "quantize": 0}
    check(executed == 40 and ex.fail_step == 20 and ex.restored_step == 20
          and ex.ckpt_steps == [10, 20, 40],
          f"train_checkpoint example: {executed} steps executed, failure at "
          f"{ex.fail_step}, restored {ex.restored_step}, saves {ex.ckpt_steps}"
          "; expected 40, 20, 20, [10, 20, 40]")
    check(counts == want, f"train_checkpoint example: kernel launches "
          f"{counts}, expected {want}")
    check(all(math.isfinite(x) for x in ex.losses)
          and ex.losses[-1] < ex.losses[0],
          f"train_checkpoint example: losses {ex.losses} not finite and falling")
    again = ex.mgr.restore(40, ex.state, num_hosts_new=3, failed_hosts=[1])
    check_bit_equal(torch, again, ex.state, "train_checkpoint example step 40")
    phase(5, "main path train_checkpoint example",
          f"{' '.join(EXAMPLE_ARGS)}: {cfg.params_total() / 1e6:.1f}M params "
          f"f32, {executed} steps in {ex_s:.3f} s with 3 saves and the "
          f"restore; losses every 10th "
          f"{', '.join(f'{x:.4f}' for x in ex.losses[9::10])}; checkpoint 40 "
          f"restored on 3 hosts bit-equal; modelled checkpoint bandwidth "
          f"{ex.ckpt_bandwidth / 1e9:.4f} GB/s (the DES, not the card); "
          f"launches {counts}")
    del ex, again
    free()

    # -- 6. times at the main-path shapes ---------------------------------------
    def flash_times(shape):
        B, T, S, H, K, D, causal, window = shape
        q, k, v = attn_inputs(torch, shape, torch.bfloat16, seed=99)
        path = fa.PATHS[fa.fwd_path(q.dtype, D, fa._aligned(q, k, v))]
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
                    library_ms=library_ms, path=path), (
            f"flash_attention bf16 {shape} ({path}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"by {b_by} ({detail}; f32 CUDA-core bound "
            f"{flops / PEAK_F32_FLOPS * 1e3:.4f} ms)")

    times, lines = {}, []
    times["flash_attention"], line = flash_times(MAIN_SHAPE)
    lines.append(line)
    times["flash_local"], line = flash_times(LOCAL_SHAPE)
    lines.append(line)
    times["flash_train"], line = flash_times(TRAIN_SHAPE)
    lines.append(line)

    # The flash backward at the starcoder2 training shape: each call is the
    # backward alone, from one forward's saved tensors.
    B, T, S, H, K, D, causal, window = TRAIN_SHAPE
    q, k, v = (x.requires_grad_() for x in
               attn_inputs(torch, TRAIN_SHAPE, torch.bfloat16, seed=96))
    dout = randn(torch, torch.Generator(device="cuda").manual_seed(95), q.shape,
                 torch.bfloat16)
    with torch.no_grad():
        o, lse, o_lo = fa._forward(q, k, v, causal, window, D ** -0.5,
                                   with_lse=True)
    path = fa.PATHS[fa.bwd_path(q.dtype, D, fa._aligned(q, k, v, dout))]
    groups = fa.bwd_groups(B, S, H, K)
    ms = time_ms(torch, lambda: fa.flash_attention_bwd_cuda(
        q, k, v, o, lse, dout, causal=causal, window=window, o_lo=o_lo), iters=10)

    def grad_ms(out, iters):
        return time_ms(torch, lambda: torch.autograd.grad(
            out, (q, k, v), dout, retain_graph=True), iters=iters)

    plain_ms = grad_ms(ref.attention_ref(q, k, v, causal=causal, window=window), 3)
    free()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True).transpose(1, 2)
    library_ms = grad_ms(library_out, 10)
    # Five products of 2*D flops per visible pair (S, dP, dV, dQ, dK); q, k,
    # v, o, dout and lse read once, dq, dk, dv written once.
    flops = 10 * D * visible_pairs(T, S, causal, window) * B * H
    b_ms, b_by, detail = bound(flops, PEAK_BF16_FLOPS, 0,
                               nbytes(q, k, v, o, dout, lse, q, k, v))
    times["flash_attention_bwd"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                        bound_by=b_by, library_ms=library_ms,
                                        path=path, groups=groups)
    lines.append(f"flash_attention backward bf16 {TRAIN_SHAPE} ({path}, "
                 f"{groups} groups): kernel {ms:.4f} "
                 f"ms, plain (autograd) {plain_ms:.4f} ms, sdpa backward "
                 f"{library_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({detail}; "
                 f"f32 CUDA-core bound {flops / PEAK_F32_FLOPS * 1e3:.4f} ms)")
    del q, k, v, dout, o, lse, o_lo, qt, kt, vt, library_out
    free()

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
    lines.append(f"ssm_scan x bf16 {SSM_MAIN[:4]}: kernel {ms:.4f} ms "
                 f"({ms / b_ms:.2f}x bound; the previous kernel "
                 f"{PREVIOUS_MS['ssm_scan']:.4f}), plain {plain_ms:.4f} ms, "
                 f"bound {b_ms:.4f} ms by {b_by} ({detail}); no library call "
                 "computes a selective scan")
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
    lines.append(f"rglru_scan bf16 {RGLRU_MAIN[:3]}: kernel {ms:.4f} ms "
                 f"({ms / b_ms:.2f}x bound; the previous kernel "
                 f"{PREVIOUS_MS['rglru_scan']:.4f}), plain {plain_ms:.4f} ms, "
                 f"bound {b_ms:.4f} ms by {b_by} ({detail}); no library call "
                 "computes an RG-LRU")
    del args, hs, hT
    free()

    x = quant_input(torch, QUANT_MAIN, torch.float32, seed=94)
    ms = time_ms(torch, lambda: qz.quantize_cuda(x), iters=20)
    plain_ms = time_ms(torch, lambda: ref.quantize_ref(x), iters=20)
    q, s = qz.quantize_cuda(x)
    R, C = QUANT_MAIN
    # per element: |x|, a max, a division, a rint, two clamps (the division
    # and rint are counted as one operation each).
    b_ms, b_by, detail = bound(6 * R * C, PEAK_F32_FLOPS, 0, nbytes(x, q, s))
    times["quantize"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None)
    lines.append(f"quantize f32 {QUANT_MAIN}: kernel {ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({detail}); "
                 "no single PyTorch call computes per-row amax int8 "
                 "quantization")
    del x, q, s
    free()
    phase(6, "times", " | ".join(lines))

    # -- 7. kernels line and result -------------------------------------------
    line = []
    for name, (m, src, _) in kernels.items():
        by_path = {path: counts[name] for path, counts in launches.items()}
        err = (main_err[("flash_attention", MAIN_SHAPE)]
               if name == "flash_attention" else main_err[name])
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/" + getattr(m, src),
                 "replaces": m.REPLACES,
                 "launches": sum(by_path.values()),
                 "max_abs_err": err, **times[name],
                 "launches_by_path": by_path}
        if name == "flash_attention":
            entry["at_recurrentgemma_local"] = dict(
                shape=list(LOCAL_SHAPE),
                max_abs_err=main_err[("flash_attention", LOCAL_SHAPE)],
                **times["flash_local"])
            entry["at_starcoder2_train"] = dict(
                shape=list(TRAIN_SHAPE),
                max_abs_err=main_err[("flash_attention", TRAIN_SHAPE)],
                lse_max_abs_err=main_err["flash_lse"], **times["flash_train"])
        if name in PREVIOUS_MS:
            entry["tiles"] = {k: getattr(m, k) for k in
                              ("CHUNK", "SEGMENT", "LANES", "CHANNELS", "STAGES")}
        if name == "flash_attention_bwd":
            entry["note"] = ("the backward of the function flash_attention_pallas "
                             "computes; the Pallas kernel has none, and the "
                             "reference differentiates its chunked jnp attention "
                             "(src/repro/kernels/ops.py:47)")
            entry["shape"] = list(TRAIN_SHAPE)
        line.append(entry)
    print(smi_line, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits nonzero
without the final result line:

1. Device: the card's name and power limit, from nvidia-smi.
2. Build: every CUDA kernel of the serving and training paths (flash
   attention forward and backward, the selective scan and the RG-LRU with
   their backwards, int8 quantization, AdamW's update, LayerNorm and
   RMSNorm forward and backward), compiled from the sources under
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
   and the main-path shapes, in f32 and bf16, among them recurrentgemma-9b's
   local training shape (B=2, T=3000, head dim 256, window 2048) and the
   MoE / encoder-decoder / vision archs' shapes: whisper-small's encoder
   (4, 1500, 1500, 12, 12, 64) and cross-attention (4, 448, 1500, 12, 12,
   64), both non-causal; paligemma-3b's training shape (4, 768, 768, 8, 1,
   256), causal with no window; granite-moe (4, 1024, 1024, 16, 8, 64) and
   phi3.5-moe (4, 1024, 1024, 32, 8, 128), forward and backward.
   jamba2-3b's training shapes: the flash forward and backward at (2, 8192,
   8192, 20, 1, 128), causal, bf16, on the wgmma kernels with 2 groups,
   against plain attention run 4 query heads at a time (its log-sum-exp
   too; dK and dV, sums over 20 heads and up to 8192 queries, by each
   key's row: its error's norm over the row's at 2e-2; the backward bit
   for bit on a second call); the scan and its
   backward at (2, 8192, 5120, 16) in f32 and bf16, dt and A drawn as
   Mamba's init draws them so that the state carries across hundreds of
   steps (the backward bit for bit on a second call).
   Tolerances: f32 atol/rtol 1e-4, bf16 outputs 2e-2, the scans' f32 final
   states 1e-4; the flash forward's log-sum-exp (written for the backward)
   against a plain logsumexp at 1e-4, with its output bit-identical to the
   forward without it; the flash backward's dQ, dK, dV against autograd of
   the plain attention at the same f32 / bf16 tolerances, and bit for bit
   equal on a second call (every bf16 head-dim 256 case, the edges of the
   wgmma kernel's 64-key tiles and both training shapes among them), as are
   both scans at their main shapes;
   quantization's int8 codes exactly equal and its
   scales within 1e-6.  The flash kernels' path queries must put the bf16
   main shapes (qwen3, llama3 (H/K 16, forward only), recurrentgemma-local
   and starcoder2 forward, starcoder2 and recurrentgemma-local backward, the
   five new shapes forward and backward) on the tensor cores (the forward
   on the wgmma kernel at head dims 64, 128 and 256: paligemma's training
   shape and recurrentgemma's local serving and training shapes among
   them; the backward on the wgmma kernel too, at every head dim the main
   paths use, 256 included) and f32 on the FMA kernels,
   and the backward's group split must be the one each case expects; the
   head-dim 256 backward runs on the wgmma forward's log-sum-exp and
   rounding residual.  The scans' backward kernels, through autograd,
   against f32 autograd of the plain scans over the same cases and the
   training shapes (falcon-mamba-7b (4, 1024, 8192, 16), recurrentgemma-9b
   (2, 3000, 4096)): per-element gradients (dx, ddt, da_gate, di_gate,
   dh0) at f32 1e-4 / bf16 2e-2, gradients summed over batch and time or
   channels (dA, dD, dB, dC, dlog_lam) by relative norm at 1e-4 / 2e-2;
   both bitwise equal on a second call at the training shapes.  AdamW's
   fused update against the optimizer's slice loop
   (``train.optimizer.update_in_slices``), p, m and v bit for bit: one leaf
   of each parameter shape of starcoder2-3b and of phi3.5-moe-42b-a6.6b
   (bf16 weights and gradients, f32 moments, step 2, the clip factor
   active, decay on matrices), and the port's other dtype sets at
   starcoder2's FFN matrix.  The norm kernels against the plain chain
   (``kernels.ref.norm_ref``) at the cells' shapes (``NORM_CASES``:
   starcoder2-3b's LayerNorm in training and prefill, with the last
   position alone, phi3.5's and jamba2-3b's RMSNorm, Jamba's dt, B and C
   norms read in place from the x_proj output), f32 at 1e-5 and bf16 at
   2e-2: y and dx elementwise, the scale's and bias's gradients by the
   relative norm of their error, a second backward bit for bit.
4. Whole models at full width, f32, kernels against plain (atol 1e-3 on
   the last-position logits): qwen3-32b 2 layers, B=1, T=256;
   falcon-mamba-7b 2 layers, B=1, T=256; recurrentgemma-9b 3 layers (one
   rglru, rglru, local super-block), B=1, T=2100, past its 2048 window;
   qwen2-72b and llama3-405b 1 layer, B=1, T=256; granite-moe-1b-a400m 2
   layers, phi3.5-moe-42b-a6.6b 1 layer, whisper-small 2 + 2 layers over
   its 1500 frames, paligemma-3b 2 layers behind its 256 patches and
   jamba2-3b 8 layers (7 mamba blocks with their FFNs, then attention),
   B=1, T=256.
   Then one starcoder2-3b train step (2 layers, B=2, T=256, AdamW lr 3e-4)
   with the flash kernels against the same step on plain attention: loss,
   grad norm and every updated parameter within 1e-3, and each leaf's
   gradient, read from its first moment ((1-b1) * clip * g after one step
   from zero), within 1e-3 of that leaf's norm; and the step with 2
   microbatches against 1 on the card, held to the same checks.  The same
   step and checks for falcon-mamba-7b (2 layers) and recurrentgemma-9b (3
   layers, so that a local layer runs), B=2, T=256: the scans' forward and
   backward kernels against the plain scans under autograd; and for
   granite-moe (2 layers), phi3.5-moe (1), whisper (2 + 2, 1500 frames),
   paligemma (2, 256 patches) and jamba2-3b (8), B=2, T=256: the flash
   kernels against plain attention under the experts, the encoder and
   cross-attention, and the patch prefix; jamba's scans and flash kernels
   against both plain versions.  The plain steps run the optimizer's slice loop in place
   of AdamW's kernel.
5. Main paths, with every kernel's launch count set to 0 just before each
   run and read just after.  ``repro_torch.launch.serve`` at full width,
   bf16, batch 4, 32 greedy decode steps: qwen3-32b 8 layers, prompt 1024
   (flash 8); falcon-mamba-7b 8 layers, prompt 1024 (ssm 8);
   recurrentgemma-9b 8 layers, prompt 3000 (rglru 6, flash 2); qwen2-72b
   8 layers and llama3-405b 4 layers, prompt 1024 (flash 8 and 4);
   granite-moe-1b-a400m all 24 layers and phi3.5-moe-42b-a6.6b 8, prompt
   1024 (flash 24 and 8); whisper-small 12 + 12 layers, 1500 frames,
   prompt 64 (flash 36: 12 encoder, 12 self, 12 cross); paligemma-3b all 18
   layers, 256 patches + prompt 256 (flash 18; the cache holds patches,
   prompt and decode, and decoding starts after the patches); jamba2-3b all
   28 layers, prompt 1024 (ssm 26, flash 2; 26 mamba states beside 2 KV
   caches); launch counts from ``serve_launches``.
   ``repro_torch.launch.train`` for falcon-mamba-7b (8 layers, B=4,
   T=1024), recurrentgemma-9b (8 layers, B=2, T=3000, past its window;
   the last 64-step chunk holds 56), granite-moe (all 24 layers, B=4,
   T=1024), phi3.5-moe (3 layers, about 4.2 B params; B=4, T=1024),
   whisper (12 + 12, B=4, the decoder's 448 positions over 1500 frames),
   paligemma (all 18, B=4, 256 patches + 512 tokens) and jamba2-3b (all
   28, B=2, T=8192, the jamba2-3b-train-8k cell's shape), bf16, one
   microbatch, 3 steps on fresh batches, then 3 more on one batch where the
   loss must fall; each checkpointed layer (``remat``,
   ``remat_policy="full"``; every layer of a super-block and every encoder
   layer) runs its forward kernels twice a step, each other layer once, and
   every scan or
   attention launch has its backward launch: falcon-mamba ssm 16 / 8 a
   step, recurrentgemma rglru 10 / 6 and flash 4 / 2, granite flash 48 /
   24, phi3.5 6 / 3, whisper 72 / 36, paligemma 36 / 18, jamba2-3b ssm
   52 / 26 and flash 4 / 2 (``train_launches``), AdamW once a leaf a step,
   the norm kernel once a norm call (the recompute's included) and its
   backward once a norm a step (``layer_norms``; a serve counts every
   norm of its prefill and decode steps).  The two MoE archs then take the loss and
   gradients of one step twice on one batch: bit for bit equal.
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
   Then the mesh phase: 4 ranks (``torch.multiprocessing.spawn``) on the
   one card over gloo (NCCL refuses two ranks on one device), a (data=2,
   model=2) DeviceMesh, every rank computing on cuda:0, each run's launch
   counts zeroed just before it and read just after, per rank.  granite-moe
   at full width under its own config (policy tp, fsdp, moe_impl a2a): in
   f32 at 4 layers with no-drop capacity (4.0), B=4, T=256, one sharded
   step against the unsharded step on rank 0 from the same parameters and
   batch: loss within 1e-4, every parameter within 5e-4 (the loss without
   the aux term, since the a2a aux is the mean of per-shard estimators; the
   aux itself within 0.5 of the global one), 2 all-to-alls per MoE layer
   forward, flash 8 / 4 per rank.  ``compressed_psum`` over the data axis,
   twice, on each rank's shard of every gradient leaf of one more loss:
   codes equal the plain ``quantize_ref`` exactly, scales within 1e-6, the
   sum within 1e-6 of the sum of the per-rank decompressions, the two calls
   bit-equal, quantize 2 per leaf.  recurrentgemma-9b at full width, 3
   layers, f32, B=2, T=2100: the sharded forward's logits at the last 64
   positions within 5e-4 of the unsharded forward's on rank 0 (rglru 2,
   flash 1 per rank); then served with its caches sharded on their
   ``cache_specs`` (the local layer's ring over the sequence): a prefill of
   B=2, 2100 tokens and 8 greedy decode steps against the unsharded serve
   on rank 0, greedy tokens equal and every step's logits within 5e-4,
   rglru 2 and flash 1 per rank (the decode steps run no kernel).
   phi3.5-moe-42b-a6.6b at full width (16 experts of d_ff 6400, top-2), 1
   layer, f32, no-drop capacity (8.0), its ``sort_scatter`` on each rank's
   shard: one sharded step (aux term in the loss) against the unsharded
   step on rank 0, loss within 1e-4 and every parameter within 5e-4, each
   rank's dot FLOPs (``StepCounter`` on its CUDA tensors) at most 0.35x the
   unsharded step's, flash 2 / 1 per rank; a sharded prefill of B=4, 256
   tokens and 4 decode steps against the unsharded serve, greedy tokens
   equal and logits within 5e-4, flash 1 per rank.  The
   granite f32 sharded state, after its step, saved through
   ``CheckpointManager`` under commit and under session (4 hosts, partner
   copies; every rank gathers, rank 0 writes) and restored on 3 hosts with
   host 1 failed: every shard file and the manifest byte-equal to rank 0's
   save of the same state gathered whole (under commit: a save's bytes do
   not depend on the model), and the restored shards bit-equal on the
   same placements.  granite bf16 at all 24 layers, B=4, T=1024, 2 steps:
   every rank the same finite losses, flash 96 / 48 and 192 all-to-alls per
   rank.  Printed: per-rank step ms and peak GB beside the card's name and
   power limit, labelled as time-shared ranks.
   Then the dry run: ``python -m repro_torch.launch.dryrun`` for qwen3-32b
   decode_32k, falcon-mamba-7b train_4k and phi3.5-moe-42b-a6.6b train_4k
   on the single-pod mesh, as subprocesses on the host (a fake group of
   256 ranks, meta tensors; started after the build, run beside the phases
   on the card): each cell's artifact must say ``status: ok`` and its dense
   FLOPs per device stay within 1.15x the reference's dry run of the cell
   (``artifacts/dryrun_reference/``, read as data); printed: wall times and
   the per-device numbers.
6. Times at the main-path shapes: kernel, plain version, the least time
   the card could take (bound, from the bytes moved and the operations
   done) and one PyTorch library call as a yardstick where one computes
   the same function (the port never calls it); each flash line names the
   path it took (``wgmma`` for every bf16 forward, head dim 256 included)
   beside SDPA's time from the same run, and each scan line the time of
   the scan kernel it replaced (one thread per channel walking all T).
   The scans' backward kernels and the flash backward at the
   recurrentgemma local training shape (head dim 256, the wgmma kernel's
   64-key dK/dV blocks) against autograd of plain and of SDPA; the flash
   forward at recurrentgemma's local serving shape (SDPA with a boolean
   mask for the window); the flash forward and backward at whisper's
   encoder shape and paligemma's training shape; the flash forward alone
   at whisper's cross-attention, llama3's, phi3.5's and granite's prefill
   shapes.  The norm kernels at starcoder2-3b's training shape beside the
   plain chain and ``F.layer_norm`` (its weights cast to bf16).
7. The ``kernels`` JSON line (the scans' entries with their tile sizes;
   ``launches`` sums the main paths' runs, the mesh phase's summed over its
   ranks),
   then the result line
   ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import atexit
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
# the forward and the backward on the tensor cores; f32 and other head dims
# run on the CUDA cores).
EXTRA_CASES = [
    (1, 40, 40, 4, 2, 256, True, 16),
    (2, 24, 8, 4, 2, 64, True, 0),
    (1, 33, 70, 8, 1, 128, False, 0),
    (1, 100, 100, 4, 2, 128, True, 24),
    (2, 65, 130, 8, 2, 64, True, 0),
    (1, 70, 70, 4, 4, 32, False, 0),
    (1, 50, 50, 2, 1, 96, True, 0),
]
# Head dim 256: T ragged against the forward's 128-row query tile and
# 64-key KV tile (the backward's 32-row tiles too), rows that see no key
# (T > S), non-causal T != S, a window that empties whole KV tiles, suffix
# queries; H/K in {1, 2, 16}.
D256_CASES = [
    (1, 100, 100, 2, 2, 256, True, 0),
    (2, 40, 24, 4, 2, 256, True, 0),
    (1, 33, 90, 16, 1, 256, False, 0),
    (1, 300, 300, 16, 1, 256, True, 64),
    (1, 130, 200, 4, 2, 256, True, 48),
]
# The tensor-core backward's paths and GQA group splits: case -> (path, G),
# path 2 the wgmma kernel (head dims 64, 128 and 256), 1 the mma.sync ones,
# and G the number of groups its dK/dV pass splits a KV head's H/K query
# heads into.  Group sizes 1, 3 and 12; G = 2 over a group of 3, which it
# does not divide; ragged T and S, T > S, suffix queries, a window,
# non-causal T != S; at head dim 256 recurrentgemma's group of 16 whole
# (G = 16) and split 6 ways, which does not divide it.  Then the wgmma
# kernel's tile edges (at head dims 64 and 128: 128 keys a dK/dV block, 128
# or 64 queries a stage, 128 dQ rows a block, 128 keys a stage; at 256: 64
# keys a dK/dV block, 64 queries a stage, 128 dQ rows a block, 64 keys a
# stage): T and S ragged, T > S, a window of 200 that leaves whole stages
# unseen, non-causal T != S, granite's GQA 2:1 and phi3.5's 4:1.
BWD_TC_GROUPS = {
    (1, 100, 100, 4, 4, 64, True, 0): (2, 1),
    (2, 70, 90, 6, 2, 32, True, 0): (1, 3),
    (1, 40, 24, 12, 4, 64, True, 0): (2, 3),
    (1, 130, 130, 12, 1, 128, True, 48): (2, 12),
    (1, 200, 150, 12, 1, 32, False, 0): (1, 12),
    (4, 1024, 1024, 12, 4, 64, True, 0): (2, 2),
    (1, 256, 256, 16, 1, 256, True, 0): (2, 16),
    (4, 700, 700, 16, 1, 256, True, 0): (2, 6),
    **{case: (2, groups) for D in (64, 128, 256) for case, groups in (
        ((1, 200, 330, 4, 2, D, True, 0), 2),
        ((1, 300, 140, 4, 1, D, True, 0), 4),
        ((1, 640, 640, 4, 2, D, True, 200), 2),
        ((2, 150, 400, 4, 2, D, False, 0), 2))},
    (1, 256, 256, 16, 8, 64, True, 0): (2, 2),
    (1, 256, 256, 32, 8, 128, True, 0): (2, 4),
}
MAIN_SHAPE = (4, 1024, 1024, 64, 8, 128, True, 0)      # qwen3-32b prefill, B=4
LOCAL_SHAPE = (4, 3000, 3000, 16, 1, 256, True, 2048)  # recurrentgemma local
TRAIN_SHAPE = (4, 1024, 1024, 24, 2, 128, True, 0)     # starcoder2-3b train, B=4
LLAMA3_SHAPE = (4, 1024, 1024, 128, 8, 128, True, 0)   # llama3-405b prefill
LOCAL_TRAIN_SHAPE = (2, 3000, 3000, 16, 1, 256, True, 2048)  # its training
# The MoE, encoder-decoder and vision archs' main shapes, each with the group
# split of its tensor-core backward: whisper-small's encoder (non-causal,
# 1500 frames) and cross-attention (448 decoder positions over 1500 frames),
# head dim 64, MHA; paligemma-3b's training shape (256 patches + 512 tokens,
# MQA 8:1, head dim 256, no window); granite-moe and phi3.5-moe prefill.
WHISPER_ENC_SHAPE = (4, 1500, 1500, 12, 12, 64, False, 0)
WHISPER_CROSS_SHAPE = (4, 448, 1500, 12, 12, 64, False, 0)
PALI_TRAIN_SHAPE = (4, 768, 768, 8, 1, 256, True, 0)
GRANITE_SHAPE = (4, 1024, 1024, 16, 8, 64, True, 0)
PHI_SHAPE = (4, 1024, 1024, 32, 8, 128, True, 0)
ARCH_SHAPES = {WHISPER_ENC_SHAPE: 1, WHISPER_CROSS_SHAPE: 1, PALI_TRAIN_SHAPE: 6,
               GRANITE_SHAPE: 1, PHI_SHAPE: 1}
ALL_ATTN = (ATTN_CASES + EXTRA_CASES + D256_CASES + list(BWD_TC_GROUPS)
            + [MAIN_SHAPE, LOCAL_SHAPE, TRAIN_SHAPE, LOCAL_TRAIN_SHAPE]
            + list(ARCH_SHAPES))
FWD_ONLY = [LLAMA3_SHAPE]
BWD_TC_GROUPS.update({TRAIN_SHAPE: (2, 4), LOCAL_SHAPE: (2, 2), LOCAL_TRAIN_SHAPE: (2, 3),
                      **{case: (2, groups) for case, groups in ARCH_SHAPES.items()}})
# Shapes whose bf16 forward must take the wgmma kernel (head dims 64, 128
# and 256; the mma.sync kernel keeps 16 and 32, which no main path uses).
TC_FORWARD = (MAIN_SHAPE, LOCAL_SHAPE, TRAIN_SHAPE, LLAMA3_SHAPE, LOCAL_TRAIN_SHAPE,
              *ARCH_SHAPES)
# jamba2-3b's training shape, B=2, T=8192: its attention layers (20 query
# heads over one KV head of dim 128, causal, no window), held apart from
# ALL_ATTN because its plain attention runs JAMBA_HEADS query heads at a
# time (all 20 at once would hold 10.7 GB a score matrix in f32), with the
# group split its tensor-core backward takes (path, G).
JAMBA_ATTN = (2, 8192, 8192, 20, 1, 128, True, 0)
JAMBA_BWD_GROUPS = (2, 2)
JAMBA_HEADS = 4
# Quantize: tests/test_kernels.py's shapes, a row of zeros, rows on exact .5
# ties, and the largest gradient leaf of the starcoder2-3b main path (the
# (3072, 12288) FFN matrix cut into 1024-wide rows by grad_compress._rows).
QUANT_CASES = [(8, 16), (7, 33), (128, 256), (1, 5), "zero-row", "ties"]
QUANT_MAIN = (36864, 1024)
# AdamW's update: the train cells' archs at full width, one leaf of each
# parameter shape, in the configs' dtypes; the port's other dtype sets
# (p, g, moments) at starcoder2-3b's FFN matrix; the timed leaf, phi3.5's
# stacked expert matrix (16 x 4096 x 6400).
ADAMW_ARCHS = ("starcoder2-3b", "phi3.5-moe-42b-a6.6b")
ADAMW_SETS_SHAPE = (3072, 12288)
ADAMW_MAIN = (16, 4096, 6400)
ADAMW_STEP, ADAMW_CLIP = 2, 0.37
# The norm kernels at the cells' shapes: (what, base shape, columns of the
# base's last dim, last position alone, kind).  starcoder2-3b's LayerNorm
# over 3072 with its bias at B=4 T=2048 and in prefill at the longest
# prompt, 4 x 4096, with the final norm's last position; phi3.5's RMSNorm
# over 4096 at B=4 T=4096; jamba2-3b's over 2560 at B=2 T=8192 and its dt,
# B and C norms, views of the (2, 8192, 192) x_proj output; f32 and bf16,
# f32 at 1e-5 (the two differ in the order of each row's f32 sums), bf16
# at 2e-2.  The timed shape: starcoder2's training norm.
NORM_CASES = (("starcoder2 train", (4, 2048, 3072), (0, 3072), False, "layernorm"),
              ("starcoder2 prefill", (4, 4096, 3072), (0, 3072), False, "layernorm"),
              ("starcoder2 prefill last", (4, 4096, 3072), (0, 3072), True, "layernorm"),
              ("phi3.5 train", (4, 4096, 4096), (0, 4096), False, "rmsnorm"),
              ("jamba2-3b train", (2, 8192, 2560), (0, 2560), False, "rmsnorm"),
              ("jamba2-3b dt", (2, 8192, 192), (0, 160), False, "rmsnorm"),
              ("jamba2-3b B", (2, 8192, 192), (160, 176), False, "rmsnorm"),
              ("jamba2-3b C", (2, 8192, 192), (176, 192), False, "rmsnorm"))
NORM_MAIN = NORM_CASES[0]
# Bt, T, I, N, with h0 -- tests/test_kernels.py SSM_CASES, then an initial
# state, T past one tile (20, 1000), I not a multiple of a channel block;
# then the chunked kernel's edges (64-step chunks of 16-step segments,
# 64-channel blocks): T in {1, 15, 64, 67, 145, 200}, I a ragged block on the
# plain-load route (71, 33) and on the cp.async route (72, 80), N in {1, 5,
# 12, 16}; then the backward kernel's own edges (8-step segments, 64-channel
# blocks, states in pairs): T = 73 ends inside a chunk's second segment, I =
# 40 is one ragged block, N = 3 a pair with a zero state; and the
# falcon-mamba-7b prefill shape.
SSM_CASES = [(1, 8, 4, 2, False), (2, 16, 8, 4, False), (1, 24, 6, 3, False),
             (2, 16, 8, 4, True), (2, 20, 200, 16, True),
             (1, 1000, 130, 16, False),
             (2, 145, 71, 16, True), (1, 1, 5, 1, False), (2, 15, 16, 5, True),
             (1, 64, 33, 16, False), (3, 67, 72, 5, True),
             (1, 200, 80, 12, True), (2, 73, 40, 3, True)]
SSM_MAIN = (4, 1024, 8192, 16, False)
# jamba2-3b's scan at its training shape (B=2, T=8192, d_inner 5120,
# d_state 16), its dt and A drawn as Mamba's published init draws them
# (``ssm_inputs(slow=True)``), so that the state carries across hundreds of
# steps and thus across many of the kernels' 64-step chunks.
JAMBA_SSM = (2, 8192, 5120, 16, False)
# B, T, L, with h0 -- tests/test_kernels.py RGLRU_CASES, then T=20 (where the
# Pallas wrapper's unmasked padding breaks h_T), T=1000 with L not a multiple
# of the 64-channel block; then the chunked kernel's edges (64-step chunks of
# 16-step segments): T in {1, 15, 64, 67, 145, 200}, L a ragged block on the
# plain-load route (71, 3) and on the cp.async route (72, 136); then the
# backward kernel's own edges (4-step segments, 32-channel blocks): T = 73
# ends inside a chunk's third segment, L = 40 leaves 8 channels; and the
# recurrentgemma-9b prefill shape.
RGLRU_CASES = [(1, 8, 4, False), (2, 16, 8, False), (1, 13, 6, False),
               (1, 20, 6, False), (2, 20, 6, True), (2, 1000, 100, True),
               (2, 145, 71, True), (1, 1, 3, False), (2, 15, 64, True),
               (1, 64, 100, False), (3, 67, 72, True), (1, 200, 136, False),
               (2, 73, 40, True)]
RGLRU_MAIN = (4, 3000, 4096, False)
# The scans' training shapes: falcon-mamba-7b's is its prefill shape, and
# recurrentgemma-9b trains at B=2 (its logits and f32 moments fill the card).
SSM_TRAIN = SSM_MAIN
RGLRU_TRAIN = (2, 3000, 4096, False)
# The scans' times at their main shapes before the chunked kernels (one
# thread per channel walking all T): this script's phase 6 on an H100 80GB
# HBM3 at 700 W.  Printed as a reference point; that kernel is not rebuilt.
PREVIOUS_MS = {"ssm_scan": 0.7920, "rglru_scan": 0.7553}


def serve_args(arch: str, prompt: int, layers: int = 8) -> list:
    return ["--arch", arch, "--layers", str(layers), "--batch", "4",
            "--prompt-len", str(prompt), "--steps", "32", "--device", "cuda",
            "--seed", "0"]


MAIN_PATHS = [("qwen3-32b", serve_args("qwen3-32b", 1024)),
              ("falcon-mamba-7b", serve_args("falcon-mamba-7b", 1024)),
              ("recurrentgemma-9b", serve_args("recurrentgemma-9b", 3000)),
              ("qwen2-72b", serve_args("qwen2-72b", 1024)),
              # 4 layers: about 34 GB of bf16 weights at llama3's widths.
              ("llama3-405b", serve_args("llama3-405b", 1024, layers=4)),
              # All 24 layers (1.39 B params); phi3.5 at 8 of 32 (10.7 B,
              # 21 GB); whisper all 12 + 12 with 1500 frames; paligemma all
              # 18 layers, its 256 patches in front of the prompt.
              ("granite-moe-1b-a400m", serve_args("granite-moe-1b-a400m", 1024,
                                                  layers=24)),
              ("phi3.5-moe-42b-a6.6b", serve_args("phi3.5-moe-42b-a6.6b", 1024)),
              ("whisper-small", serve_args("whisper-small", 64, layers=12)),
              ("paligemma-3b", serve_args("paligemma-3b", 256, layers=18)),
              # All 28 layers: 26 mamba states beside 2 KV caches.
              ("jamba2-3b", serve_args("jamba2-3b", 1024, layers=28))]


def train_args(arch: str, batch: int, seq: int, layers: int = 8) -> list:
    return ["--arch", arch, "--layers", str(layers), "--batch", str(batch),
            "--seq", str(seq), "--steps", "3", "--microbatches", "1",
            "--device", "cuda", "--seed", "0"]


# These archs train through launch.train with one microbatch (their configs'
# microbatches size the reference's multi-chip step): the recurrent archs at
# 8 layers; granite-moe at all 24; phi3.5-moe at 3 (about 4.2 B params, 50 GB
# of weights, gradients and f32 moments); whisper at 12 + 12 with the
# decoder's published 448 positions over 1500 frames; paligemma at all 18,
# 256 patches + 512 tokens; jamba2-3b at all 28 (3.2 B params, about 52 GB
# with its 8k activations), B=2, T=8192, the jamba2-3b-train-8k cell's shape.
TRAIN_PATHS = [("falcon-mamba-7b", train_args("falcon-mamba-7b", 4, 1024)),
                   ("recurrentgemma-9b", train_args("recurrentgemma-9b", 2, 3000)),
                   ("granite-moe-1b-a400m",
                    train_args("granite-moe-1b-a400m", 4, 1024, layers=24)),
                   ("phi3.5-moe-42b-a6.6b",
                    train_args("phi3.5-moe-42b-a6.6b", 4, 1024, layers=3)),
                   ("whisper-small", train_args("whisper-small", 4, 448, layers=12)),
                   ("paligemma-3b", train_args("paligemma-3b", 4, 512, layers=18)),
                   ("jamba2-3b", train_args("jamba2-3b", 2, 8192, layers=28))]
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


# Every kernel's launch counter, in the order of the kernels line.
KERNELS = ("flash_attention", "flash_attention_bwd", "ssm_scan", "ssm_scan_bwd",
           "rglru_scan", "rglru_scan_bwd", "quantize", "adamw", "norm", "norm_bwd")


def kernel_table() -> dict:
    """name -> (module, its source attribute, its launch counter), in the
    order of KERNELS."""
    from repro_torch.kernels import adamw as ak
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import norm as nk
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssm_scan as ss
    kernels = {"flash_attention": (fa, "SOURCE", "LAUNCHES"),
               "flash_attention_bwd": (fa, "BWD_SOURCE", "BWD_LAUNCHES"),
               "ssm_scan": (ss, "SOURCE", "LAUNCHES"),
               "ssm_scan_bwd": (ss, "BWD_SOURCE", "BWD_LAUNCHES"),
               "rglru_scan": (rs, "SOURCE", "LAUNCHES"),
               "rglru_scan_bwd": (rs, "BWD_SOURCE", "BWD_LAUNCHES"),
               "quantize": (qz, "SOURCE", "LAUNCHES"),
               "adamw": (ak, "SOURCE", "LAUNCHES"),
               "norm": (nk, "SOURCE", "LAUNCHES"),
               "norm_bwd": (nk, "SOURCE", "BWD_LAUNCHES")}
    check(tuple(kernels) == KERNELS, "kernel table out of step with KERNELS")
    return kernels


def reset_launches(kernels) -> None:
    for m, _, counter in kernels.values():
        setattr(m, counter, 0)


def read_launches(kernels) -> dict:
    return {name: getattr(m, counter) for name, (m, _, counter) in kernels.items()}


def expect(**counts) -> dict:
    """Launch counts of a run: the given ones, 0 for every other kernel."""
    return {name: counts.get(name, 0) for name in KERNELS}


def layer_norms(cfg, t: str, decode: bool = False) -> int:
    """Norm calls of one decoder layer of type ``t`` over a sequence (or in
    one decode step): before its mixer, before its FFN (a mamba block
    without one has none), before an encoder-decoder's cross-attention
    (every block but mamba's has one); qk-norm's two on an attention
    layer's queries and keys, and two more on the cross-attention's (its
    query alone in a decode step, whose keys are cached); a mamba mixer's
    dt, B and C norms."""
    cross = cfg.kind == "encdec" and t != "mamba"
    n = 1 + int(t != "mamba" or cfg.mamba_ffn) + int(cross)
    if cfg.qk_norm and t in ("attn", "local"):
        n += 2 + (1 if decode else 2) * int(cross)
    if t == "mamba" and cfg.mamba_dt_bc_norm:
        n += 3
    return n


def enc_layer_norms(cfg) -> int:
    """Norm calls of one encoder layer: before attention and FFN, and
    qk-norm's two."""
    return 2 + 2 * int(cfg.qk_norm)


def layer_launches(cfg, t: str) -> dict:
    """Forward kernel launches of one decoder layer of type ``t``: its mixer's
    kernel, and for an encoder-decoder one flash launch more for its
    cross-attention (every block but mamba's has one); its norms
    (``layer_norms``)."""
    cross = int(cfg.kind == "encdec" and t != "mamba")
    return {"flash_attention": int(t in ("attn", "local")) + cross,
            "ssm_scan": int(t == "mamba"), "rglru_scan": int(t == "rglru"),
            "norm": layer_norms(cfg, t)}


def serve_launches(cfg, decode_steps: int = 0) -> dict:
    """Launches of one prefill of ``cfg`` and ``decode_steps`` decode steps:
    each layer's (``layer_launches``) and the final norm; one flash launch
    and its norms per encoder layer and the encoder's final norm; a decode
    step runs each layer's norms and the final norm (its other one-token
    functions are plain torch)."""
    types = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    counts = {name: sum(layer_launches(cfg, t)[name] for t in types)
              for name in ("flash_attention", "ssm_scan", "rglru_scan", "norm")}
    counts["norm"] += 1
    if cfg.kind == "encdec":
        counts["flash_attention"] += cfg.enc_layers
        counts["norm"] += cfg.enc_layers * enc_layer_norms(cfg) + 1
    counts["norm"] += decode_steps * (
        sum(layer_norms(cfg, t, decode=True) for t in types) + 1)
    return expect(**counts)


def model_leaves(cfg) -> int:
    """Non-empty parameter leaves of ``cfg``'s model: AdamW's kernel
    launches once for each in a step."""
    from repro_torch.models.transformer import Transformer
    return local_leaves(Transformer(cfg, device="meta").parameters())


def local_leaves(params) -> int:
    """Parameters whose local tensor (a DTensor's shard on this rank) is
    non-empty: AdamW's kernel skips an empty one."""
    from torch.distributed.tensor import DTensor
    return sum(1 for p in params
               if (p.to_local() if isinstance(p, DTensor) else p).numel())


def train_launches(cfg, steps: int, leaves: int) -> dict:
    """Launches of ``steps`` train steps of ``cfg`` with one microbatch,
    whose optimizer updates ``leaves`` non-empty leaves (0 for a loss and
    its gradients alone).  Under ``remat`` (``remat_policy="full"``) each
    layer of a super-block and each encoder layer is checkpointed, so they
    run their forward kernels twice a step (the forward and its recomputation
    in the backward), the remainder layers once; every forward launch has
    one backward launch (a norm's backward is a pair of launches, counted
    as one call); the final norms (the decoder's, an encoder's) run once a
    step; AdamW launches once a leaf a step."""
    check(not cfg.remat or cfg.remat_policy == "full",
          f"{cfg.name}: remat_policy {cfg.remat_policy!r}, not 'full'")
    P = len(cfg.pattern)
    ckpt = cfg.n_super * P if cfg.remat else 0
    types = [cfg.pattern[i % P] for i in range(cfg.n_layers)]
    fwd = {"flash_attention": 0, "ssm_scan": 0, "rglru_scan": 0, "norm": 1}
    bwd = dict(fwd)
    for i, t in enumerate(types):
        for name, n in layer_launches(cfg, t).items():
            fwd[name] += (2 if i < ckpt else 1) * n
            bwd[name] += n
    if cfg.kind == "encdec":
        fwd["flash_attention"] += (2 if cfg.remat else 1) * cfg.enc_layers
        bwd["flash_attention"] += cfg.enc_layers
        enc = cfg.enc_layers * enc_layer_norms(cfg)
        fwd["norm"] += (2 if cfg.remat else 1) * enc + 1
        bwd["norm"] += enc + 1
    return expect(**{name: steps * n for name, n in fwd.items()},
                  **{f"{name}_bwd": steps * n for name, n in bwd.items()},
                  adamw=steps * leaves)


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


def ssm_inputs(torch, case, dtype, seed, slow: bool = False):
    """x, dt, A, B, C, D, h0 as the main path gives them: x, B, C in the
    working dtype, dt f32 (softplus'd), A negative, D and h0 f32.  With
    ``slow``, dt and A as Mamba's init draws them: dt log-uniform in
    [0.001, 0.1] and A[:, n] = -(n + 1), so that a channel's state decays
    over 10 to 16,000 steps."""
    Bt, T, I, N, with_h0 = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = randn(torch, g, (Bt, T, I), dtype)
    dt = torch.nn.functional.softplus(randn(torch, g, (Bt, T, I)))
    A = -torch.exp(randn(torch, g, (I, N)))
    if slow:
        u = torch.rand((Bt, T, I), generator=g, device="cuda")
        dt = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
        A = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda").repeat(I, 1)
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


def adamw_leaf(torch, shape, dtypes, seed):
    """p, g, m, v of ``shape`` in the dtypes (p, g, moments), as a train
    step holds them after some steps: small weights and gradients, v
    positive."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    scales = (0.02, 1e-3, 1e-4, 1e-4)
    out = [randn(torch, g, shape) * sc for sc in scales]
    out[3] = out[3] * out[3]
    return [t.to(dt) for t, dt in zip(out, (dtypes[0], dtypes[1], dtypes[2], dtypes[2]))]


def adamw_scalars(torch, clip: float, step: int):
    """clip, bc1 and bc2 as ``adamw_update`` makes them on the card."""
    from repro_torch.train.optimizer import AdamWConfig
    opt = AdamWConfig()
    f32 = dict(dtype=torch.float32, device="cuda")
    stepf = torch.tensor(step, dtype=torch.int32, device="cuda").float()
    return (torch.tensor(clip, **f32), 1 - torch.tensor(opt.b1, **f32) ** stepf,
            1 - torch.tensor(opt.b2, **f32) ** stepf)


def adamw_hyper() -> dict:
    from repro_torch.train.optimizer import AdamWConfig
    opt = AdamWConfig()
    return dict(lr=opt.lr, b1=opt.b1, b2=opt.b2, eps=opt.eps,
                weight_decay=opt.weight_decay)


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


def rows_vs_plain(torch, got, want, tol, what):
    """Largest relative norm of ``got``'s error against ``want`` over the
    last dim, row by row; raises beyond ``tol`` or on a non-finite value."""
    w = want.float()
    rel = (got.float() - w).norm(dim=-1) / w.norm(dim=-1).clamp(min=1e-30)
    worst = rel.max().item()
    check(worst <= tol and bool(torch.isfinite(got).all()),
          f"{what}: a row misses by {worst:.3e} of its norm, beyond {tol}")
    return worst


def grads_vs_plain(torch, run, plain, ins, cots, dtype, names, summed, what):
    """Gradients of sum(out * cot) over a scan's two outputs through ``run``
    (the kernels) against f32 autograd of ``plain`` on the same values:
    the ``summed`` ones by the relative norm of their error (1e-4 in f32,
    2e-2 in bf16), every other one elementwise at the same tolerance.
    Returns the largest elementwise abs error."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    ins = [None if t is None else t.clone().requires_grad_() for t in ins]
    outs = run(*ins)
    loss = sum((o.float() * c.float()).sum() for o, c in zip(outs, cots)
               if c is not None)
    got = torch.autograd.grad(loss, [t for t in ins if t is not None])
    insf = [None if t is None else t.detach().float().requires_grad_()
            for t in ins]
    outs = plain(*insf)
    loss = sum((o * c.float()).sum() for o, c in zip(outs, cots) if c is not None)
    want = torch.autograd.grad(loss, [t for t in insf if t is not None])
    worst = 0.0
    for name, g, w in zip([n for n, t in zip(names, ins) if t is not None],
                          got, want):
        if name in summed:
            rel = ((g.float() - w).norm() / w.norm().clamp(min=1e-30)).item()
            check(rel <= tol and bool(torch.isfinite(g).all()),
                  f"{what}: d{name} misses by {rel:.3e} of its norm, beyond {tol}")
        else:
            worst = max(worst, compare(torch, g, w, tol, f"{what}: d{name}"))
    return worst


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


def attention_by_heads(torch, ref, q, k, v, causal: bool, window: int, dout=None):
    """Plain attention of q's heads over one KV head, JAMBA_HEADS query
    heads at a time: the output and log-sum-exp, or with ``dout`` f32
    autograd's (dq, dk, dv) of the same, dk and dv summed over the heads."""
    H, c = q.shape[2], JAMBA_HEADS
    check(k.shape[2] == 1 and H % c == 0, f"attention_by_heads: {H} heads over "
          f"{k.shape[2]} KV heads, in groups of {c}")
    if dout is None:
        out = torch.cat([ref.attention_ref(q[:, :, h:h + c], k, v, causal=causal,
                                           window=window) for h in range(0, H, c)], 2)
        lse = torch.cat([lse_plain(torch, q[:, :, h:h + c], k, causal, window)
                         for h in range(0, H, c)], 1)
        return out, lse
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    grads = [torch.zeros_like(x) for x in (qf, kf, vf)]
    for h in range(0, H, c):
        o = ref.attention_ref(qf[:, :, h:h + c], kf, vf, causal=causal, window=window)
        for acc, g in zip(grads, torch.autograd.grad(o, (qf, kf, vf),
                                                     dout[:, :, h:h + c].float())):
            acc += g
        del o
    return grads


def jamba_kernel_checks(torch, fa, ss, ref, tols, main_err: dict, paths: dict) -> int:
    """jamba2-3b's training shapes against the plain versions (phase 3):
    the flash forward and backward at JAMBA_ATTN in bf16 (its path, group
    split, log-sum-exp, and the backward's bits on a second call), the
    scan forward and backward at JAMBA_SSM in f32 and bf16 (and the
    backward's bits on a second call), all at phase 3's tolerances.
    Records the errors in ``main_err`` and the paths in ``paths``; returns
    the number of cases."""
    case = JAMBA_ATTN
    B, T, S, H, K, D, causal, window = case
    q, k, v = attn_inputs(torch, case, torch.bfloat16, seed=1300)
    with torch.inference_mode():
        o, lse, _ = fa._forward(q, k, v, causal, window, D ** -0.5, with_lse=True)
        got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        check(torch.equal(o, got), f"flash_attention_cuda {case} bf16: output "
              "with the log-sum-exp differs from without")
        path = fa.fwd_path(torch.bfloat16, D, fa._aligned(q, k, v, got))
        check(path == 2, f"flash_attention_cuda {case} bf16: path {fa.PATHS[path]}, "
              "not wgmma")
        paths[("flash_attention", case)] = path
        want, lse_want = attention_by_heads(torch, ref, q, k, v, causal, window)
        main_err[("flash_attention", case)] = compare(
            torch, got, want, tols[torch.bfloat16], f"flash_attention_cuda {case} bf16")
        main_err[("flash_lse", case)] = compare(
            torch, lse, lse_want, 1e-4, f"flash_attention_cuda lse {case} bf16")
        del o, lse, got, want, lse_want
    free()
    dout = randn(torch, torch.Generator(device="cuda").manual_seed(1301), q.shape,
                 torch.bfloat16)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(fa.flash_attention_cuda(qg, kg, vg, causal=causal,
                                                      window=window), (qg, kg, vg), dout)
    again = torch.autograd.grad(fa.flash_attention_cuda(qg, kg, vg, causal=causal,
                                                        window=window), (qg, kg, vg), dout)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_attention backward {case} bf16: two calls differ")
    del again
    path = fa.bwd_path(torch.bfloat16, D, fa._aligned(q, k, v, dout))
    groups = fa.bwd_groups(B, S, H, K, D)
    check((path, groups) == JAMBA_BWD_GROUPS, f"flash_attention backward {case} "
          f"bf16: path {fa.PATHS[path]}, {groups} groups; expected "
          f"{fa.PATHS[JAMBA_BWD_GROUPS[0]]}, {JAMBA_BWD_GROUPS[1]} groups")
    paths[("flash_attention_bwd", case)] = path
    # dq elementwise; dk and dv each key's row at once: they sum 20 query
    # heads x up to 8192 queries, so where a sum cancels to near 0 it
    # still carries the rounding of its large terms (bf16 P in the
    # kernel's products; 6.4e-2 at a value near 0 on the card), as the
    # scans' summed gradients are held by their error's relative norm.
    want = attention_by_heads(torch, ref, q, k, v, causal, window, dout=dout)
    tol = tols[torch.bfloat16]
    main_err[("flash_attention_bwd", case)] = compare(
        torch, got[0], want[0], tol, f"flash_attention backward dq {case} bf16")
    main_err[("flash_rows_bwd", case)] = max(
        rows_vs_plain(torch, g, w, tol, f"flash_attention backward d{name} {case} bf16")
        for name, g, w in zip("kv", got[1:], want[1:]))
    del q, k, v, qg, kg, vg, dout, got, want
    free()
    n = 2
    Bt, T, I, N, _ = JAMBA_SSM
    for dtype, tol in tols.items():
        args = ssm_inputs(torch, JAMBA_SSM, dtype, seed=1310, slow=True)
        with torch.inference_mode():
            y, hT = ss.ssm_scan_cuda(*args)
            y_ref, hT_ref = ref.ssm_scan_ref(*args)
            err = compare(torch, y, y_ref, tol, f"ssm_scan_cuda y {JAMBA_SSM} {dtype}")
            compare(torch, hT, hT_ref, 1e-4, f"ssm_scan_cuda h_T {JAMBA_SSM} {dtype}")
        del y, hT, y_ref, hT_ref
        g = torch.Generator(device="cuda").manual_seed(1311)
        cots = (randn(torch, g, (Bt, T, I), dtype), randn(torch, g, (Bt, I, N)))
        berr = grads_vs_plain(torch, ss.ssm_scan_cuda, ref.ssm_scan_ref, args, cots,
                              dtype, ("x", "dt", "A", "B", "C", "D", "h0"),
                              ("A", "B", "C", "D"), f"ssm_scan backward {JAMBA_SSM} {dtype}")
        if dtype == torch.bfloat16:
            main_err[("ssm_scan", JAMBA_SSM)] = err
            main_err[("ssm_scan_bwd", JAMBA_SSM)] = berr
        n += 2
        del args, cots
        free()
    with torch.no_grad():
        args = ss._prepare(*ssm_inputs(torch, JAMBA_SSM, torch.bfloat16, seed=1312,
                                       slow=True))
        _, _, carries = ss._forward(*args, save=True)
        dy = randn(torch, torch.Generator(device="cuda").manual_seed(1313),
                   args[0].shape, torch.bfloat16)
        first, second = (ss.ssm_scan_bwd_cuda(dy, None, *args[:6], carries)
                         for _ in range(2))
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"ssm_scan backward {JAMBA_SSM} bf16: two calls differ")
        del args, carries, dy, first, second
    free()
    return n + 1


def norm_case(torch, case, dtype, seed):
    """(base, view, scale, bias, dy) of a NORM_CASES entry: base drawn about
    0.5 with spread 2, the normalised view of it, an f32 scale about 1, a
    bias for LayerNorm, and a cotangent of the view's shape."""
    what, shape, (lo, hi), last, kind = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = (randn(torch, g, shape) * 2 + 0.5).to(dtype)

    def view(t):
        t = t[..., lo:hi]
        return t[:, -1:] if last else t

    scale = 1 + 0.1 * randn(torch, g, (hi - lo,))
    bias = 0.1 * randn(torch, g, (hi - lo,)) if kind == "layernorm" else None
    dy = randn(torch, g, view(base).shape, dtype)
    return base, view, scale, bias, dy


def norm_grads(torch, fn, base, view, scale, bias, dy):
    """y = fn(view(base), scale, bias) and the gradients of <y, dy> by base,
    scale and bias, from fresh leaves (a view keeps its strides)."""
    leaves = [t.clone().requires_grad_() for t in (base, scale, bias) if t is not None]
    y = fn(view(leaves[0]), *leaves[1:], *([None] if bias is None else []))
    return y.detach(), torch.autograd.grad(y, leaves, dy)


def norm_kernel_checks(torch, nk, ref, main_err: dict) -> int:
    """The norm kernels against the plain chain at NORM_CASES (phase 3), f32
    at 1e-5 and bf16 at 2e-2: y and dx elementwise, dscale and dbias (sums
    over every row) by the relative norm of their error; one forward and
    one backward call each; a second backward bit-equal.  Records the bf16
    errors of y and dx in ``main_err`` ("norm", "norm_bwd"); returns the
    number of cases."""
    tols = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    errs, n = {"norm": 0.0, "norm_bwd": 0.0}, 0
    for i, case in enumerate(NORM_CASES):
        kind = case[-1]
        for dtype, tol in tols.items():
            what = f"norm {case[0]} {kind} {str(dtype).removeprefix('torch.')}"
            base, view, scale, bias, dy = norm_case(torch, case, dtype, seed=1400 + i)
            before = (nk.LAUNCHES, nk.BWD_LAUNCHES)
            y, grads = norm_grads(torch, lambda a, s_, b: nk.norm_cuda(a, s_, b, kind, 1e-6),
                                  base, view, scale, bias, dy)
            torch.cuda.synchronize()
            check((nk.LAUNCHES, nk.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1),
                  f"{what}: launches {nk.LAUNCHES - before[0]} forward, "
                  f"{nk.BWD_LAUNCHES - before[1]} backward, expected 1 and 1")
            y_ref, grads_ref = norm_grads(
                torch, lambda a, s_, b: ref.norm_ref(a, s_, b, kind, 1e-6),
                base, view, scale, bias, dy)
            e_y = compare(torch, y, y_ref, tol, f"{what} y")
            e_dx = compare(torch, grads[0], grads_ref[0], tol, f"{what} dx")
            for name, g, want in zip(("dscale", "dbias"), grads[1:], grads_ref[1:]):
                rel = ((g - want).norm() / want.norm().clamp(min=1e-30)).item()
                check(rel <= tol, f"{what} {name}: misses by {rel:.3e} of its norm")
            _, again = norm_grads(torch, lambda a, s_, b: nk.norm_cuda(a, s_, b, kind, 1e-6),
                                  base, view, scale, bias, dy)
            for name, a, b in zip(("dx", "dscale", "dbias"), grads, again):
                check(torch.equal(a, b), f"{what}: a second backward's {name} differs")
            if dtype == torch.bfloat16:
                errs["norm"] = max(errs["norm"], e_y)
                errs["norm_bwd"] = max(errs["norm_bwd"], e_dx)
            n += 1
            del base, scale, bias, dy, y, grads, y_ref, grads_ref, again
            free()
    main_err.update(errs)
    return n


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


# The mesh phase: 4 ranks time-share the one card on a (data=2, model=2) mesh
# over gloo (NCCL refuses two ranks on one device); every rank computes on
# cuda:0.  granite-moe-1b-a400m at full width under its own config (policy
# tp, fsdp, moe_impl a2a): in f32 at 4 layers with no-drop capacity, one
# sharded step against the unsharded step on the same card (B=4, T=256);
# in bf16 at all 24 layers, B=4, T=1024, 2 steps at the config's capacity.
# recurrentgemma-9b at full width, 3 layers (one period of its pattern), f32,
# B=2, T=2100 (past its 2048 window): the sharded forward's logits at the
# last 64 positions against the unsharded forward's.
MESH_SHAPE = (2, 2)
MESH_RANKS = MESH_SHAPE[0] * MESH_SHAPE[1]
MESH_F32 = dict(layers=4, batch=4, seq=256, capacity=4.0)
MESH_BF16 = dict(batch=4, seq=1024, steps=2)
MESH_RG = dict(layers=3, batch=2, seq=2100, last=64, steps=8)
# phi3.5-moe-42b-a6.6b at full width (16 experts of d_ff 6400, top-2), 1
# layer, f32, sort_scatter at a no-drop capacity (E / k: C = B*T): one
# sharded step against the unsharded step, each rank's dot FLOPs against
# the unsharded step's, and a sharded prefill of B=4 T=256 with 4 decode
# steps against the unsharded serve.
MESH_PHI = dict(layers=1, batch=4, seq=256, capacity=8.0, steps=4, flops=0.35)
MESH_CKPT_HOSTS = 4
# The dry run's cells: (arch, shape), single-pod mesh.  Each cell's dense
# FLOPs per device must stay within DRYRUN_FLOPS of the reference's own dry
# run of the cell, read from its committed record.
DRYRUN_CELLS = (("qwen3-32b", "decode_32k"), ("falcon-mamba-7b", "train_4k"),
                ("phi3.5-moe-42b-a6.6b", "train_4k"))
DRYRUN_FLOPS = 1.15
REFERENCE_DRYRUN = ROOT / "artifacts" / "dryrun_reference"


def file_bytes(mgr, path: str, node: int) -> bytes:
    """A BaseFS file's bytes, read through ``mgr``'s consistency layer."""
    fh = mgr.layer.open(990_000, path, node=node)
    mgr._open_session(fh)
    size = mgr.layer.stat_size(fh)
    mgr.layer.seek(fh, 0)
    return bytes(mgr.layer.read(fh, size))


def ckpt_paths(step: int) -> list:
    """(path, node) of every file a save at ``step`` writes."""
    H = MESH_CKPT_HOSTS
    return [(f"/ckpt/step_{step}/shard_{h}.bin{sfx}", (h + p) % H)
            for h in range(H) for sfx, p in (("", 0), (".partner", 1))] + [
        (f"/ckpt/step_{step}/MANIFEST", 0)]


def mesh_rank(rank: int, workdir: str) -> None:
    """One rank of the mesh phase.  Writes what it measured and checked to
    ``workdir/rank{rank}.json``; any failure raises, which fails the phase."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            rank=rank, world_size=MESH_RANKS,
                            timeout=datetime.timedelta(seconds=600))
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import ref
    from repro_torch.launch import mesh as MS
    from repro_torch.launch.hlostats import StepCounter
    from repro_torch.models import moe
    from repro_torch.models import sharding as sh
    from repro_torch.models.transformer import Transformer, init_params, param_specs
    from repro_torch.serve.decode import make_prefill, make_serve_step
    from repro_torch.train import grad_compress as gc_
    from repro_torch.train.train_step import (loss_fn, make_train_step,
                                              train_state_init)

    kernels = kernel_table()
    mesh = MS.make_mesh(MESH_SHAPE, ("data", "model"), "cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": rank}

    def reset():
        reset_launches(kernels)
        moe.A2A_CALLS = 0
        torch.cuda.synchronize()

    def counts():
        torch.cuda.synchronize()
        return read_launches(kernels)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def in_turn(build):
        """``build()`` on one rank at a time: each builds its whole model
        before slicing it, and one whole copy at a time fits beside the
        shards."""
        res = None
        for r in range(MESH_RANKS):
            if r == rank:
                res = build()
                torch.cuda.empty_cache()
            dist.barrier()
        return res

    def max_diff(model, plain):
        """Max |sharded - unsharded| over every parameter (rank 0's
        unsharded copy), and the leaf where it is."""
        worst = (0.0, "")
        for n, p in model.named_parameters():
            full = p.full_tensor().detach()
            if plain is not None:
                worst = max(worst, (float((full.float() - plain[n].float()).abs().max()), n))
            del full
        return worst

    # granite f32, 4 layers, no-drop capacity: one sharded step against the
    # unsharded one.  The loss leaves out the aux term: the a2a aux is the
    # mean of per-shard estimators (the reference's pmean), another function
    # than the unsharded global one; its value is bounded apart.
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"), dtype=torch.float32,
                              n_layers=MESH_F32["layers"],
                              moe_capacity=MESH_F32["capacity"])
    rules = MS.arch_rules(cfg, multi_pod=False)
    opt = MS.opt_for(cfg)
    step = make_train_step(cfg, opt, num_microbatches=1, aux_weight=0.0)
    batch = synthetic_batch(31, cfg, MESH_F32["batch"], MESH_F32["seq"], dev)
    plain = None
    if rank == 0:
        st, pm = step(train_state_init(gen(0), cfg, opt, dev), batch)
        plain = {n: p.detach() for n, p in st["params"].named_parameters()}
        out["f32_plain"] = {"loss": float(pm["loss"]), "aux": float(pm["moe_aux"])}
        del st, pm
    dist.barrier()
    state = in_turn(lambda: MS.sharded_train_state(init_params(cfg, gen(0), dev),
                                                   cfg, opt, mesh, rules))
    dbatch = MS.distribute_batch(batch, mesh, rules)
    reset()
    t0 = time.perf_counter()
    with sh.active_rules(rules, mesh):
        state, met = step(state, dbatch)
    loss = float(met["loss"])
    ms = (time.perf_counter() - t0) * 1e3
    out["f32"] = {"counts": counts(), "a2a": moe.A2A_CALLS, "loss": loss,
                  "aux": float(met["moe_aux"]), "ms": ms,
                  "leaves": local_leaves(state["params"].parameters())}
    out["f32"]["param_err"], out["f32"]["param_err_leaf"] = max_diff(state["params"], plain)
    del plain

    # The sharded state through CheckpointManager under commit and session:
    # rank 0's bytes against one save of the same state gathered whole (a
    # save's bytes and manifest do not depend on the consistency model),
    # and the restored shards against the saved ones.
    whole = {n: p.full_tensor().detach() for n, p in state["params"].named_parameters()}
    moments = {k: {n: t.full_tensor() for n, t in state["opt"][k].items()}
               for k in ("m", "v")}
    plain_mgr = None
    if rank == 0:
        m = Transformer(cfg, device=dev)
        m.load_state_dict(whole)
        plain_mgr = CheckpointManager(model="commit", num_hosts=MESH_CKPT_HOSTS,
                                      partner=True)
        plain_mgr.save(2, {"params": m.requires_grad_(True),
                           "opt": {**moments, "step": state["opt"]["step"].clone()},
                           "step": state["step"].clone()})
        del m
    del whole, moments
    out["ckpt"] = {}
    for cm in ("commit", "session"):
        mgr = CheckpointManager(model=cm, num_hosts=MESH_CKPT_HOSTS, partner=True)
        t0 = time.perf_counter()
        manifest = mgr.save(2, state)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = mgr.restore(2, state, num_hosts_new=MESH_CKPT_HOSTS - 1,
                           failed_hosts=[1])
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        pairs = [(a, b) for (_, a), (_, b) in zip(state["params"].named_parameters(),
                                                  back["params"].named_parameters())]
        pairs += [(state["opt"][k][n], back["opt"][k][n]) for k in ("m", "v")
                  for n in state["opt"][k]]
        same = all(tuple(a.placements) == tuple(b.placements)
                   and torch.equal(a.to_local(), b.to_local()) for a, b in pairs)
        same = (same and torch.equal(state["step"], back["step"])
                and torch.equal(state["opt"]["step"], back["opt"]["step"]))
        res = {"restored": bool(same), "save_ms": save_ms, "restore_ms": restore_ms,
               "gb": sum(p["nbytes"] for leaf in manifest["leaves"].values()
                         for p in leaf["parts"]) / 1e9}
        del back, pairs
        if rank == 0:
            res["bytes_equal"] = all(file_bytes(mgr, p, n) == file_bytes(plain_mgr, p, n)
                                     for p, n in ckpt_paths(2))
            res["manifest_equal"] = manifest == plain_mgr.manifests[2]
        out["ckpt"][cm] = res
        del mgr
        gc.collect()
    del plain_mgr

    # compressed_psum over the data axis on each rank's shard of every
    # gradient leaf of one more loss: twice per leaf inside the count window.
    with sh.active_rules(rules, mesh):
        loss, _ = loss_fn(state["params"], dbatch, cfg, 0.0)
        named = dict(state["params"].named_parameters())
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        grads = sh.shard_tree(grads, param_specs(cfg))
    local = {n: g.to_local().detach() for n, g in grads.items()}
    del grads, loss, state, met, named
    reset()
    sums = {n: (gc_.compressed_psum(x, mesh, "data"), gc_.compressed_psum(x, mesh, "data"))
            for n, x in local.items()}
    cp = {"counts": counts(), "leaves": len(local), "code_bad": [], "twice_bad": [],
          "sum_err": 0.0, "scale_err": 0.0}
    group = sh.mesh_group(mesh, "data")
    for n, x in local.items():
        t1, t2 = sums[n]
        if not torch.equal(t1, t2):
            cp["twice_bad"].append(n)
        q, s = gc_.compress(x)
        q_ref, s_ref = ref.quantize_ref(gc_._rows(x))
        if not torch.equal(q, q_ref):
            cp["code_bad"].append(n)
        cp["scale_err"] = max(cp["scale_err"], float(((s - s_ref).abs()
                                                      / s_ref.abs().clamp(min=1e-30)).max()))
        deq = gc_.decompress(q, s, x.shape, torch.float32)
        parts = [torch.empty_like(deq) for _ in range(MESH_SHAPE[0])]
        dist.all_gather(parts, deq, group=group)
        want = parts[0]
        for part in parts[1:]:
            want = want + part
        err = (t1.float() - want).abs() / (1.0 + want.abs())
        cp["sum_err"] = max(cp["sum_err"], float(err.max()))
    out["compressed_psum"] = cp
    del local, sums
    torch.cuda.empty_cache()

    # recurrentgemma f32, 3 layers: the sharded forward against the
    # unsharded one (rank 0), the RG-LRU and the windowed flash kernel on
    # each rank's shard.
    rcfg = dataclasses.replace(get_config("recurrentgemma-9b"), dtype=torch.float32,
                               n_layers=MESH_RG["layers"])
    rrules = MS.arch_rules(rcfg, multi_pod=False)
    toks = torch.randint(0, rcfg.vocab, (MESH_RG["batch"], MESH_RG["seq"]),
                         generator=gen(41), device=dev)
    last = MESH_RG["last"]

    def serve(m, prompt, whole, steps=MESH_RG["steps"]):
        """Greedy tokens and last-position logits of a prefill and
        ``steps`` decode steps, each taken whole by ``whole``."""
        tok, logits, cache = make_prefill(m, prompt.shape[1] + steps)(prompt)
        toks_out, logits_out = [whole(tok)], [whole(logits).float()]
        step = make_serve_step(m)
        for i in range(steps):
            tok, logits, cache = step(cache, tok[:, None], prompt.shape[1] + i)
            toks_out.append(whole(tok))
            logits_out.append(whole(logits).float())
        return toks_out, logits_out

    def build_rg():
        m = init_params(rcfg, gen(0), dev)
        plain = served = None
        if rank == 0:
            with torch.no_grad():
                plain = m(toks)[0][:, -last:].clone()
                served = serve(m, toks, lambda t: t)
        sh.distribute_model(m, param_specs(rcfg), rrules, mesh)
        return m, plain, served

    model, rplain, rserve = in_turn(build_rg)
    reset()
    t0 = time.perf_counter()
    with sh.active_rules(rrules, mesh), torch.no_grad():
        logits, _ = model(MS.distribute_batch({"t": toks}, mesh, rrules)["t"])
        got = logits[:, -last:].full_tensor()
    ms = (time.perf_counter() - t0) * 1e3
    out["rg"] = {"counts": counts(), "ms": ms, "finite": bool(torch.isfinite(got).all())}
    if rank == 0:
        out["rg"]["err"] = float(((got - rplain).abs() / (1.0 + rplain.abs())).max())
    del rplain, logits, got
    torch.cuda.empty_cache()

    # The same model served with sharded caches: prefill and 8 greedy decode
    # steps against the unsharded serve (rank 0, computed before the model
    # was sharded).
    reset()
    t0 = time.perf_counter()
    with sh.active_rules(rrules, mesh), torch.no_grad():
        stoks, slogits = serve(model, MS.distribute_batch({"t": toks}, mesh, rrules)["t"],
                               lambda t: t.full_tensor())
    ms = (time.perf_counter() - t0) * 1e3
    out["rg_serve"] = {"counts": counts(), "ms": ms}
    if rank == 0:
        out["rg_serve"]["tokens_equal"] = all(torch.equal(a, b) for a, b in
                                              zip(stoks, rserve[0]))
        out["rg_serve"]["err"] = max(float(((a - b).abs() / (1.0 + b.abs())).max())
                                     for a, b in zip(slogits, rserve[1]))
        out["rg_serve"]["tokens"] = [t.tolist() for t in stoks]
    del model, stoks, slogits, rserve
    torch.cuda.empty_cache()

    # phi3.5-moe f32, full width, 1 layer, no-drop capacity: sort_scatter
    # on each rank's shard, the aux term in the loss.  Rank 0 serves and
    # steps the unsharded model first; each rank's dot FLOPs of the step
    # are counted on its CUDA tensors.
    pcfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"), dtype=torch.float32,
                               n_layers=MESH_PHI["layers"],
                               moe_capacity=MESH_PHI["capacity"])
    prules = MS.arch_rules(pcfg, multi_pod=False)
    popt = MS.opt_for(pcfg)
    pstep = make_train_step(pcfg, popt, num_microbatches=1)
    pbatch = synthetic_batch(71, pcfg, MESH_PHI["batch"], MESH_PHI["seq"], dev)
    ptoks = torch.randint(0, pcfg.vocab, (MESH_PHI["batch"], MESH_PHI["seq"]),
                          generator=gen(72), device=dev)
    plain = pserved = None
    if rank == 0:
        m = init_params(pcfg, gen(0), dev)
        with torch.no_grad():
            pserved = serve(m, ptoks, lambda t: t, MESH_PHI["steps"])
        del m
        st = train_state_init(gen(0), pcfg, popt, dev)
        with StepCounter() as count:
            st, pm = pstep(st, pbatch)
        plain = {n: p.detach() for n, p in st["params"].named_parameters()}
        out["phi_plain"] = {"loss": float(pm["loss"]), "aux": float(pm["moe_aux"]),
                            "flops": count.totals()["dense_flops"]}
        del st, pm
        torch.cuda.empty_cache()
    dist.barrier()
    state = in_turn(lambda: MS.sharded_train_state(init_params(pcfg, gen(0), dev),
                                                   pcfg, popt, mesh, prules))
    reset()
    t0 = time.perf_counter()
    with sh.active_rules(prules, mesh), torch.no_grad():
        stoks, slogits = serve(state["params"],
                               MS.distribute_batch({"t": ptoks}, mesh, prules)["t"],
                               lambda t: t.full_tensor(), MESH_PHI["steps"])
    out["phi_serve"] = {"counts": counts(), "ms": (time.perf_counter() - t0) * 1e3}
    if rank == 0:
        out["phi_serve"]["tokens_equal"] = all(torch.equal(a, b) for a, b in
                                               zip(stoks, pserved[0]))
        out["phi_serve"]["err"] = max(float(((a - b).abs() / (1.0 + b.abs())).max())
                                      for a, b in zip(slogits, pserved[1]))
        out["phi_serve"]["tokens"] = [t.tolist() for t in stoks]
    del stoks, slogits, pserved
    dbatch = MS.distribute_batch(pbatch, mesh, prules)
    reset()
    t0 = time.perf_counter()
    with StepCounter() as count, sh.active_rules(prules, mesh):
        state, met = pstep(state, dbatch)
    loss = float(met["loss"])
    out["phi"] = {"counts": counts(), "ms": (time.perf_counter() - t0) * 1e3,
                  "loss": loss, "aux": float(met["moe_aux"]),
                  "flops": count.totals()["dense_flops"],
                  "leaves": local_leaves(state["params"].parameters())}
    out["phi"]["param_err"], out["phi"]["param_err_leaf"] = max_diff(state["params"], plain)
    del plain, state, met, dbatch
    torch.cuda.empty_cache()

    # granite bf16, all 24 layers, 2 steps on fresh batches.
    gcfg = get_config("granite-moe-1b-a400m")
    grules = MS.arch_rules(gcfg, multi_pod=False)
    gopt = MS.opt_for(gcfg)
    gstep = make_train_step(gcfg, gopt, num_microbatches=1)
    state = in_turn(lambda: MS.sharded_train_state(init_params(gcfg, gen(0), dev),
                                                   gcfg, gopt, mesh, grules))
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    reset()
    for i in range(MESH_BF16["steps"]):
        b = MS.distribute_batch(synthetic_batch(50 + i, gcfg, MESH_BF16["batch"],
                                                MESH_BF16["seq"], dev), mesh, grules)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sh.active_rules(grules, mesh):
            state, met = gstep(state, b)
        losses.append(float(met["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["bf16"] = {"counts": counts(), "a2a": moe.A2A_CALLS, "losses": losses,
                   "step_ms": step_ms,
                   "leaves": local_leaves(state["params"].parameters()),
                   "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    with open(f"{workdir}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def start_dryruns() -> list:
    """Start ``python -m repro_torch.launch.dryrun`` for each of
    DRYRUN_CELLS, one subprocess each, off the card; returns (arch, shape,
    process, log file, wall seconds once it exits) for each."""
    import os
    import tempfile
    import threading
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    out = []

    def waiter(proc, t0, wall):
        proc.wait()
        wall.append(time.perf_counter() - t0)

    for arch, shape in DRYRUN_CELLS:
        log = tempfile.TemporaryFile(mode="w+")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", "single"], cwd=str(ROOT), env=env,
            stdout=log, stderr=subprocess.STDOUT)
        wall: list = []
        threading.Thread(target=waiter, args=(proc, t0, wall), daemon=True).start()
        out.append((arch, shape, proc, log, wall))
    # Stopped on any way out, a failed phase included.
    atexit.register(lambda: [p.kill() for _, _, p, _, _ in out if p.poll() is None])
    return out


def finish_dryruns(dryruns: list) -> None:
    """Wait for the dry-run cells, check each artifact says ``status: ok``
    and its dense FLOPs per device are within DRYRUN_FLOPS of the
    reference's record of the cell, and print its wall time and per-device
    numbers."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import dryrun
    lines = []
    for arch, shape, proc, log, walls in dryruns:
        rc = proc.wait(timeout=900)
        while not walls:                 # the waiter thread records the exit
            time.sleep(0.01)
        wall = walls[0]
        log.seek(0)
        text = log.read()
        log.close()
        with open(dryrun._artifact_path(arch, shape, "single")) as f:
            rec = json.load(f)
        check(rc == 0 and rec["status"] == "ok",
              f"dry run {arch} {shape}: rc {rc}, status {rec['status']}: "
              f"{rec.get('error', '')}\n{text[-3000:]}")
        ref_path = REFERENCE_DRYRUN / Path(dryrun._artifact_path(arch, shape, "single")).name
        ref = json.loads(ref_path.read_text())["hlo_flops_per_device"]
        ratio = rec["dense_flops_per_device"] / ref
        check(ratio <= DRYRUN_FLOPS,
              f"dry run {arch} {shape}: dense FLOPs per device "
              f"{rec['dense_flops_per_device']:.4e}, {ratio:.3f}x the reference's "
              f"{ref:.4e} ({ref_path.relative_to(ROOT)}), above {DRYRUN_FLOPS}x")
        gib = 2 ** 30
        lines.append(
            f"{arch} {shape} ({rec['mode']}, {rec['devices']} ranks, mesh "
            f"{rec['mesh_shape']}): wall {wall:.1f} s (build {rec['build_s']} s, "
            f"trace {rec['trace_s']} s); per device: state "
            f"{rec['state_bytes_per_device'] / gib:.3f} GiB, cache "
            f"{rec.get('cache_bytes_per_device', 0) / gib:.3f} GiB, saved "
            f"{rec.get('saved_bytes_per_device', 0) / gib:.3f} GiB, fits 80 GB "
            f"{rec['fits_80gb']}, FLOPs {rec['flops_per_device']:.4e} (dense "
            f"{rec['dense_flops_per_device']:.4e}, {ratio:.4f}x the reference's "
            f"{ref:.4e}), op bytes "
            f"{rec['op_bytes_per_device']:.4e}, collective wire bytes "
            f"{rec['collectives']['wire_bytes_per_device']:.4e} "
            f"{rec['collectives']['count_by_kind']}, kernels "
            + json.dumps({k: v["launches"] for k, v in rec["kernels"].items()}))
    phase(5, "dry run", " | ".join(lines))


def run_mesh_phase(torch, launches: dict, smi_line: str) -> None:
    """The mesh phase: spawn the ranks (:func:`mesh_rank`), check what they
    report, print it, and add their launch counts, summed over the ranks, to
    ``launches``."""
    from repro_torch.configs.registry import get_config
    # Spawned after every other main path has freed its memory.  Each rank's
    # launch counts are read around each of its runs; a rank that fails
    # raises here.
    import tempfile

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        mp.spawn(mesh_rank, args=(workdir,), nprocs=MESH_RANKS)
        mesh_s = time.perf_counter() - t0
        ranks = []
        for r in range(MESH_RANKS):
            with open(f"{workdir}/rank{r}.json") as f:
                ranks.append(json.load(f))
    f32cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                                 dtype=torch.float32, n_layers=MESH_F32["layers"],
                                 moe_capacity=MESH_F32["capacity"])
    gcfg = get_config("granite-moe-1b-a400m")
    pcfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"), dtype=torch.float32,
                               n_layers=MESH_PHI["layers"],
                               moe_capacity=MESH_PHI["capacity"])
    rcfg = dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=MESH_RG["layers"])

    def a2a_calls(cfg, steps):
        """Two all-to-alls per MoE layer forward; a checkpointed layer runs
        its forward twice a step."""
        return 2 * steps * cfg.n_layers * (2 if cfg.remat else 1)

    # AdamW launches once a step for each leaf whose shard on the rank is
    # not empty.
    for r in ranks:
        runs_r = {"f32": (train_launches(f32cfg, 1, r["f32"]["leaves"]),
                          a2a_calls(f32cfg, 1)),
                  "bf16": (train_launches(gcfg, MESH_BF16["steps"], r["bf16"]["leaves"]),
                           a2a_calls(gcfg, MESH_BF16["steps"])),
                  "rg": (serve_launches(rcfg), None),
                  "rg_serve": (serve_launches(rcfg, MESH_RG["steps"]), None),
                  "phi": (train_launches(pcfg, 1, r["phi"]["leaves"]), None),
                  "phi_serve": (serve_launches(pcfg, MESH_PHI["steps"]), None),
                  "compressed_psum": (expect(quantize=2 * r["compressed_psum"]["leaves"]),
                                      None)}
        for run, (want, a2a) in runs_r.items():
            check(r[run]["counts"] == want, f"mesh rank {r['rank']} {run}: kernel "
                  f"launches {r[run]['counts']}, expected {want}")
            if a2a is not None:
                check(r[run]["a2a"] == a2a, f"mesh rank {r['rank']} {run}: "
                      f"{r[run]['a2a']} all-to-alls, expected {a2a}")
        cp = r["compressed_psum"]
        check(not cp["code_bad"] and not cp["twice_bad"] and cp["sum_err"] <= 1e-6
              and cp["scale_err"] <= 1e-6, f"mesh rank {r['rank']} compressed_psum: "
              f"codes differ from plain in {cp['code_bad']}, two calls differ in "
              f"{cp['twice_bad']}, sum err {cp['sum_err']}, scale err {cp['scale_err']}")
        check(r["f32"]["loss"] == ranks[0]["f32"]["loss"]
              and r["bf16"]["losses"] == ranks[0]["bf16"]["losses"]
              and all(math.isfinite(x) for x in r["bf16"]["losses"])
              and r["rg"]["finite"], f"mesh rank {r['rank']}: losses "
              f"{r['f32']['loss']}, {r['bf16']['losses']} differ from rank 0's or "
              "are not finite, or non-finite logits")
    r0 = ranks[0]
    check(abs(r0["f32"]["loss"] - r0["f32_plain"]["loss"]) <= 1e-4
          and r0["f32"]["param_err"] <= 5e-4,
          f"mesh granite f32: sharded loss {r0['f32']['loss']!r} against "
          f"unsharded {r0['f32_plain']['loss']!r}; max parameter error "
          f"{r0['f32']['param_err']} at {r0['f32']['param_err_leaf']}")
    check(abs(r0["f32"]["aux"] - r0["f32_plain"]["aux"]) < 0.5,
          f"mesh granite f32: a2a aux {r0['f32']['aux']} against the global "
          f"{r0['f32_plain']['aux']}")
    check(r0["rg"]["err"] <= 5e-4, f"mesh recurrentgemma: sharded logits off "
          f"the unsharded by {r0['rg']['err']}")
    rs_ = r0["rg_serve"]
    check(rs_["tokens_equal"] and rs_["err"] <= 5e-4,
          f"mesh recurrentgemma serve: sharded greedy tokens equal the unsharded "
          f"{rs_['tokens_equal']}, logits off by {rs_['err']}")
    pp = r0["phi_plain"]
    check(abs(r0["phi"]["loss"] - pp["loss"]) <= 1e-4
          and abs(r0["phi"]["aux"] - pp["aux"]) <= 1e-4
          and r0["phi"]["param_err"] <= 5e-4,
          f"mesh phi3.5 f32: sharded loss {r0['phi']['loss']!r} (aux "
          f"{r0['phi']['aux']!r}) against unsharded {pp['loss']!r} (aux {pp['aux']!r}); "
          f"max parameter error {r0['phi']['param_err']} at {r0['phi']['param_err_leaf']}")
    ps = r0["phi_serve"]
    check(ps["tokens_equal"] and ps["err"] <= 5e-4,
          f"mesh phi3.5 serve: sharded greedy tokens equal the unsharded "
          f"{ps['tokens_equal']}, logits off by {ps['err']}")
    for r in ranks:
        check(r["phi"]["loss"] == r0["phi"]["loss"]
              and r["phi"]["flops"] <= MESH_PHI["flops"] * pp["flops"],
              f"mesh rank {r['rank']} phi3.5: loss {r['phi']['loss']} (rank 0 "
              f"{r0['phi']['loss']}), dot FLOPs {r['phi']['flops']:.4e} against "
              f"{MESH_PHI['flops']} x the unsharded step's {pp['flops']:.4e}")
    for r in ranks:
        for cm, res in r["ckpt"].items():
            check(res["restored"], f"mesh rank {r['rank']} checkpoint {cm}: the "
                  "restored shards differ from the saved ones")
    for cm, res in r0["ckpt"].items():
        check(res["bytes_equal"] and res["manifest_equal"],
              f"mesh checkpoint {cm}: the sharded save differs from the unsharded "
              f"one (bytes equal {res['bytes_equal']}, manifest equal "
              f"{res['manifest_equal']})")
    for run in ("f32", "compressed_psum", "rg", "rg_serve", "phi", "phi_serve", "bf16"):
        launches[f"mesh {run}"] = {k: sum(r[run]["counts"][k] for r in ranks)
                                   for k in KERNELS}
    phase(5, "main path mesh granite-moe-1b-a400m f32",
          f"{MESH_RANKS} ranks, mesh (data={MESH_SHAPE[0]}, model={MESH_SHAPE[1]}) "
          f"over gloo on one card, {f32cfg.n_layers} layers, B={MESH_F32['batch']} "
          f"T={MESH_F32['seq']}, capacity {f32cfg.moe_capacity}: sharded step loss "
          f"{r0['f32']['loss']:.6f} against unsharded {r0['f32_plain']['loss']:.6f}; "
          f"max parameter error {r0['f32']['param_err']:.3e} "
          f"({r0['f32']['param_err_leaf']}); a2a aux {r0['f32']['aux']:.6f}, "
          f"global {r0['f32_plain']['aux']:.6f}; all-to-alls per rank "
          f"{r0['f32']['a2a']}; launches per rank {r0['f32']['counts']}")
    cp = r0["compressed_psum"]
    phase(5, "main path mesh compressed_psum",
          f"{cp['leaves']} gradient leaves, twice each over the data axis: codes "
          "equal plain, sums within 1e-6 of the per-rank decompressions "
          f"(worst {max(r['compressed_psum']['sum_err'] for r in ranks):.3e}), two "
          f"calls bit-equal; launches per rank {cp['counts']}")
    phase(5, "main path mesh recurrentgemma-9b f32",
          f"{MESH_RG['layers']} layers, B={MESH_RG['batch']} T={MESH_RG['seq']}: "
          f"sharded logits at the last {MESH_RG['last']} positions within "
          f"{r0['rg']['err']:.3e} of the unsharded; launches per rank "
          f"{r0['rg']['counts']}")
    phase(5, "main path mesh recurrentgemma-9b serve",
          f"{MESH_RG['layers']} layers f32, caches sharded on their specs, prefill "
          f"B={MESH_RG['batch']} T={MESH_RG['seq']} and {MESH_RG['steps']} decode "
          f"steps: greedy tokens equal the unsharded serve's "
          f"({rs_['tokens'][-1]} at the last step), logits within {rs_['err']:.3e}; "
          f"launches per rank {rs_['counts']}")
    phase(5, "main path mesh granite-moe-1b-a400m f32 checkpoint",
          "; ".join(f"{cm}: {res['gb']:.3f} GB a copy, every shard file and the "
                    "manifest byte-equal to the unsharded save, restored on "
                    f"{MESH_CKPT_HOSTS - 1} hosts (host 1 failed) bit-equal on the "
                    f"same placements; save ms per rank "
                    f"{[round(r['ckpt'][cm]['save_ms'], 3) for r in ranks]}, restore "
                    f"ms per rank {[round(r['ckpt'][cm]['restore_ms'], 3) for r in ranks]}"
                    for cm, res in r0["ckpt"].items()))
    pflops = ", ".join(f"{r['phi']['flops']:.4e}" for r in ranks)
    phase(5, "main path mesh phi3.5-moe-42b-a6.6b f32",
          f"{pcfg.n_layers} layer at full width ({pcfg.moe_experts} experts of d_ff "
          f"{pcfg.d_ff}, top-{pcfg.moe_topk}), B={MESH_PHI['batch']} "
          f"T={MESH_PHI['seq']}, capacity {pcfg.moe_capacity} (no drops), sort_scatter "
          f"on each rank's shard: sharded step loss {r0['phi']['loss']:.6f} (aux "
          f"{r0['phi']['aux']:.6f}) against unsharded {pp['loss']:.6f} (aux "
          f"{pp['aux']:.6f}); max parameter error {r0['phi']['param_err']:.3e} "
          f"({r0['phi']['param_err_leaf']}); dot FLOPs per rank "
          f"{pflops} against the unsharded step's "
          f"{pp['flops']:.4e} (at most {MESH_PHI['flops']}x: "
          f"{max(r['phi']['flops'] for r in ranks) / pp['flops']:.4f}x); launches per "
          f"rank {r0['phi']['counts']}")
    phase(5, "main path mesh phi3.5-moe-42b-a6.6b serve",
          f"prefill B={MESH_PHI['batch']} T={MESH_PHI['seq']} and {MESH_PHI['steps']} "
          f"decode steps, caches sharded: greedy tokens equal the unsharded serve's "
          f"({ps['tokens'][-1]} at the last step), logits within {ps['err']:.3e}; "
          f"launches per rank {ps['counts']}")
    phase(5, "main path mesh granite-moe-1b-a400m bf16",
          f"{gcfg.n_layers} layers, B={MESH_BF16['batch']} T={MESH_BF16['seq']}, "
          f"{MESH_BF16['steps']} steps: losses "
          f"{', '.join(f'{x:.4f}' for x in r0['bf16']['losses'])} on every rank; "
          f"all-to-alls per rank {r0['bf16']['a2a']}; launches per rank "
          f"{r0['bf16']['counts']}")
    print(f"mesh times, {MESH_RANKS} ranks time-sharing one card over gloo (not a "
          f"multi-card number), {smi_line}: granite bf16 {gcfg.n_layers} layers step "
          f"ms per rank {[[round(x, 3) for x in r['bf16']['step_ms']] for r in ranks]}, "
          f"peak GB per rank {[round(r['bf16']['peak_gb'], 3) for r in ranks]}; "
          f"granite f32 {f32cfg.n_layers}-layer step ms per rank "
          f"{[round(r['f32']['ms'], 3) for r in ranks]}; recurrentgemma "
          f"{MESH_RG['layers']}-layer forward ms per rank "
          f"{[round(r['rg']['ms'], 3) for r in ranks]}, sharded serve (prefill + "
          f"{MESH_RG['steps']} steps) ms per rank "
          f"{[round(r['rg_serve']['ms'], 3) for r in ranks]}; phi3.5 1-layer step ms "
          f"per rank {[round(r['phi']['ms'], 3) for r in ranks]}, sharded serve (prefill "
          f"+ {MESH_PHI['steps']} steps) ms per rank "
          f"{[round(r['phi_serve']['ms'], 3) for r in ranks]}; phase wall {mesh_s:.1f} s",
          flush=True)


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
    from repro_torch.kernels import adamw as ak
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import norm as nk
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_launch
    from repro_torch.models.transformer import init_params
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models.frontends import extra_inputs
    from repro_torch.serve.decode import prefix_len
    from repro_torch.train import grad_compress as gc_
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (loss_fn, make_train_step,
                                              train_state_init)

    kernels = kernel_table()
    sources = [getattr(m, src) for m, src, _ in kernels.values()]

    def reset_counts():
        reset_launches(kernels)

    def read_counts():
        return read_launches(kernels)

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
    # The dry run needs no card: its cells run on the host beside the phases
    # on the card, and are waited for after the mesh phase.
    dryruns = start_dryruns()

    # -- 3. kernels against plain ---------------------------------------------
    main_err, paths = {}, {}
    n_cases = 0
    with torch.inference_mode():
        for dtype, tol in tols.items():
            for i, case in enumerate(ALL_ATTN + FWD_ONLY):
                causal, window = case[6], case[7]
                q, k, v = attn_inputs(torch, case, dtype, seed=i)
                got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
                path = fa.fwd_path(dtype, case[5], fa._aligned(q, k, v, got))
                check(dtype == torch.bfloat16 or path == 0,
                      f"flash_attention_cuda {case} f32: path {path}, not the FMA kernel")
                main = case in TC_FORWARD
                if dtype == torch.bfloat16 and main:
                    want_path = 2 if case[5] in fa.WGMMA_TILES else 1
                    check(path == want_path, f"flash_attention_cuda {case} bf16: "
                          f"path {fa.PATHS[path]}, not {fa.PATHS[want_path]}")
                    paths[("flash_attention", case)] = path
                want = ref.attention_ref(q, k, v, causal=causal, window=window)
                err = compare(torch, got, want, tol, f"flash_attention_cuda {case} {dtype}")
                if dtype == torch.bfloat16 and main:
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
            check(dtype != torch.bfloat16 or D not in fa.WGMMA_BWD_TILES or path == 2,
                  f"flash_attention backward {case} bf16: path {fa.PATHS[path]}, "
                  "not wgmma")
            if dtype == torch.bfloat16 and case in BWD_TC_GROUPS:
                want_path, want_groups = BWD_TC_GROUPS[case]
                groups = fa.bwd_groups(B, S, H, K, D)
                check(path == want_path and groups == want_groups,
                      f"flash_attention backward {case} bf16: path "
                      f"{fa.PATHS[path]}, {groups} groups; expected "
                      f"{fa.PATHS[want_path]}, {want_groups} groups")
            if dtype == torch.bfloat16 and case in (TRAIN_SHAPE, LOCAL_TRAIN_SHAPE):
                paths[("flash_attention_bwd", case)] = path
            qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
            want = torch.autograd.grad(
                ref.attention_ref(qf, kf, vf, causal=causal, window=window),
                (qf, kf, vf), dout.float())
            errs = [compare(torch, g, w, tol,
                            f"flash_attention backward d{name} {case} {dtype}")
                    for name, g, w in zip("qkv", got, want)]
            if dtype == torch.bfloat16 and case == TRAIN_SHAPE:
                main_err["flash_attention_bwd"] = max(errs)
            if dtype == torch.bfloat16 and case == LOCAL_TRAIN_SHAPE:
                main_err["flash_local_bwd"] = max(errs)
            if dtype == torch.bfloat16 and case in ARCH_SHAPES:
                main_err[("flash_attention_bwd", case)] = max(errs)
                paths[("flash_attention_bwd", case)] = path
            if dtype == torch.bfloat16 and D == 256:
                again = torch.autograd.grad(
                    fa.flash_attention_cuda(q, k, v, causal=causal, window=window),
                    (q, k, v), dout)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"flash_attention backward {case} bf16: two calls differ")
                del again
            n_cases += 1
            del q, k, v, qf, kf, vf, dout, got, want
            free()
    # The backward is deterministic: a second call gives the same bits (G=4
    # at the training shape, G=2 over a group of 3, G=3 at recurrentgemma's
    # local training shape and G=6 at paligemma's, head dim 256).
    for i, case in enumerate((TRAIN_SHAPE, (4, 1024, 1024, 12, 4, 64, True, 0),
                              LOCAL_TRAIN_SHAPE, PALI_TRAIN_SHAPE)):
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
    # The scans' backward kernels, through autograd, against f32 autograd of
    # the plain scans: the forward's cases, with a cotangent on h_T in every
    # other case, and the training shapes.
    for dtype in tols:
        for i, case in enumerate(SSM_CASES + [SSM_TRAIN]):
            Bt, T, I, N, _ = case
            ins = ssm_inputs(torch, case, dtype, seed=900 + i)
            g = torch.Generator(device="cuda").manual_seed(950 + i)
            cots = (randn(torch, g, (Bt, T, I), dtype),
                    randn(torch, g, (Bt, I, N)) if i % 2 else None)
            err = grads_vs_plain(torch, ss.ssm_scan_cuda, ref.ssm_scan_ref, ins,
                                 cots, dtype, ("x", "dt", "A", "B", "C", "D", "h0"),
                                 ("A", "B", "C", "D"),
                                 f"ssm_scan backward {case} {dtype}")
            if dtype == torch.bfloat16 and case == SSM_TRAIN:
                main_err["ssm_scan_bwd"] = err
            n_cases += 1
            del ins, cots
            free()
        for i, case in enumerate(RGLRU_CASES + [RGLRU_TRAIN]):
            B, T, L, _ = case
            ins = rglru_inputs(torch, case, dtype, seed=1000 + i)
            g = torch.Generator(device="cuda").manual_seed(1050 + i)
            cots = (randn(torch, g, (B, T, L), dtype),
                    randn(torch, g, (B, L)) if i % 2 else None)
            err = grads_vs_plain(torch, rs.rglru_scan_cuda, ref.rglru_ref, ins,
                                 cots, dtype, ("x", "a_gate", "i_gate", "log_lam",
                                               "h0"), ("log_lam",),
                                 f"rglru_scan backward {case} {dtype}")
            if dtype == torch.bfloat16 and case == RGLRU_TRAIN:
                main_err["rglru_scan_bwd"] = err
            n_cases += 1
            del ins, cots
            free()
    # No atomics: a second backward call at the training shapes gives the
    # same bits.
    with torch.no_grad():
        args = ss._prepare(*ssm_inputs(torch, SSM_TRAIN, torch.bfloat16, seed=1100))
        _, _, carries = ss._forward(*args, save=True)
        dy = randn(torch, torch.Generator(device="cuda").manual_seed(1101),
                   args[0].shape, torch.bfloat16)
        first, second = (ss.ssm_scan_bwd_cuda(dy, None, *args[:6], carries)
                         for _ in range(2))
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"ssm_scan backward {SSM_TRAIN} bf16: two calls differ")
        del args, carries, dy, first, second
        free()
        args = rs._prepare(*rglru_inputs(torch, RGLRU_TRAIN, torch.bfloat16,
                                         seed=1102))
        _, _, carries = rs._forward(*args, 8.0, save=True)
        dh = randn(torch, torch.Generator(device="cuda").manual_seed(1103),
                   args[0].shape, torch.bfloat16)
        first, second = (rs.rglru_scan_bwd_cuda(dh, None, *args[:4], carries)
                         for _ in range(2))
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"rglru_scan backward {RGLRU_TRAIN} bf16: two calls differ")
        n_cases += 2
        del args, carries, dh, first, second
        free()
    # jamba2-3b's training shapes: flash at T=8192 with 20 query heads over
    # one KV head, the scan at T=8192 with a state that carries far.
    n_cases += jamba_kernel_checks(torch, fa, ss, ref, tols, main_err, paths)
    # AdamW's fused update against the optimizer's slice loop, p, m and v
    # bit for bit: one leaf of each parameter shape of the train cells'
    # archs in their configs' dtypes, then the port's other dtype sets.
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.optimizer import update_in_slices
    hyper = adamw_hyper()
    scalars = adamw_scalars(torch, ADAMW_CLIP, ADAMW_STEP)
    adamw_cases = []
    for arch in ADAMW_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=1)
        shapes = sorted({tuple(p.shape) for p in
                         Transformer(cfg, device="meta").parameters()})
        adamw_cases += [(arch, shape, (cfg.dtype, cfg.dtype, cfg.opt_state_dtype))
                        for shape in shapes]
    adamw_cases += [("dtype set", ADAMW_SETS_SHAPE, dtypes)
                    for dtypes in ak.DTYPE_SETS
                    if dtypes != adamw_cases[0][2]]

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    with torch.no_grad():
        for i, (what, shape, dtypes) in enumerate(adamw_cases):
            leaf = adamw_leaf(torch, shape, dtypes, seed=1200 + i)
            plain = [t.clone() for t in leaf]
            decay = len(shape) >= 2
            ak.adamw_cuda(*leaf, *scalars, **hyper, decay=decay)
            update_in_slices(*plain, *scalars, **hyper, decay=decay)
            for name, got, want in zip("pgmv", leaf, plain):
                check(torch.equal(bits(got), bits(want)),
                      f"adamw {what} {shape} {dtypes}: {name} differs from the "
                      "slice loop's bits")
            n_cases += 1
            del leaf, plain
            free()
    main_err["adamw"] = 0.0
    n_norm = norm_kernel_checks(torch, nk, ref, main_err)
    n_cases += n_norm
    path_line = ", ".join(
        f"{name} {fa.PATHS[p]}" for name, p in (
            ("qwen3 forward", paths[("flash_attention", MAIN_SHAPE)]),
            ("llama3 forward", paths[("flash_attention", LLAMA3_SHAPE)]),
            ("recurrentgemma-local forward", paths[("flash_attention", LOCAL_SHAPE)]),
            ("recurrentgemma-local train forward",
             paths[("flash_attention", LOCAL_TRAIN_SHAPE)]),
            ("starcoder2 forward", paths[("flash_attention", TRAIN_SHAPE)]),
            ("starcoder2 backward", paths[("flash_attention_bwd", TRAIN_SHAPE)]),
            ("recurrentgemma-local backward",
             paths[("flash_attention_bwd", LOCAL_TRAIN_SHAPE)])))
    arch_line = "; ".join(
        f"{name} {case}: forward {fa.PATHS[paths[('flash_attention', case)]]} "
        f"{main_err[('flash_attention', case)]:.3e}, backward "
        f"{fa.PATHS[paths[('flash_attention_bwd', case)]]} "
        f"{ARCH_SHAPES[case]} groups {main_err[('flash_attention_bwd', case)]:.3e}"
        for name, case in (("whisper encoder", WHISPER_ENC_SHAPE),
                           ("whisper cross", WHISPER_CROSS_SHAPE),
                           ("paligemma train", PALI_TRAIN_SHAPE),
                           ("granite", GRANITE_SHAPE), ("phi3.5", PHI_SHAPE)))
    phase(3, "kernels against plain",
          f"{n_cases} cases; paths (bf16): {path_line}; f32 on the FMA "
          "kernels; flash backward, both scans and both scan backwards "
          "deterministic (9 cases bitwise equal); "
          "main-path max abs err: flash qwen3 bf16 "
          f"{main_err[('flash_attention', MAIN_SHAPE)]:.3e}, flash local bf16 "
          f"{main_err[('flash_attention', LOCAL_SHAPE)]:.3e}, flash starcoder2 "
          f"bf16 {main_err[('flash_attention', TRAIN_SHAPE)]:.3e} (its lse "
          f"{main_err['flash_lse']:.3e}), ssm bf16 "
          f"{main_err['ssm_scan']:.3e}, rglru bf16 {main_err['rglru_scan']:.3e}, "
          f"flash llama3 bf16 {main_err[('flash_attention', LLAMA3_SHAPE)]:.3e}, "
          f"ssm backward bf16 {main_err['ssm_scan_bwd']:.3e} and rglru backward "
          f"bf16 {main_err['rglru_scan_bwd']:.3e} (elementwise gradients, "
          "against f32 autograd of plain), "
          f"flash backward starcoder2 bf16 {main_err['flash_attention_bwd']:.3e} "
          f"and recurrentgemma-local bf16 {main_err['flash_local_bwd']:.3e} "
          "(against f32 autograd of plain), "
          f"quantize scales f32 {main_err['quantize']:.3e} (codes equal); the "
          f"MoE / encoder-decoder / vision shapes, bf16 max abs err: {arch_line}; "
          f"jamba2-3b bf16 max abs err: flash {JAMBA_ATTN} forward "
          f"{fa.PATHS[paths[('flash_attention', JAMBA_ATTN)]]} "
          f"{main_err[('flash_attention', JAMBA_ATTN)]:.3e} (its lse "
          f"{main_err[('flash_lse', JAMBA_ATTN)]:.3e}), backward "
          f"{fa.PATHS[paths[('flash_attention_bwd', JAMBA_ATTN)]]} "
          f"{JAMBA_BWD_GROUPS[1]} groups dq "
          f"{main_err[('flash_attention_bwd', JAMBA_ATTN)]:.3e}, dk and dv (a key's "
          f"row, relative) {main_err[('flash_rows_bwd', JAMBA_ATTN)]:.3e}; ssm {JAMBA_SSM[:4]} "
          f"{main_err[('ssm_scan', JAMBA_SSM)]:.3e}, its backward "
          f"{main_err[('ssm_scan_bwd', JAMBA_SSM)]:.3e}; "
          f"adamw p, m and v bit-equal to the slice loop at {len(adamw_cases)} "
          f"leaves ({', '.join(f'{w} {sh}' for w, sh, _ in adamw_cases)}); "
          f"norm forward and backward at {n_norm} cases "
          f"({', '.join(c[0] for c in NORM_CASES)}; f32 and bf16) against the "
          f"plain chain, bf16 max abs err y {main_err['norm']:.3e}, dx "
          f"{main_err['norm_bwd']:.3e}, a second backward bit-equal")

    # -- 4. whole models at full width, kernels against plain -----------------
    plain = {"flash_attention": ref.attention_ref, "ssm_scan": ref.ssm_scan_ref,
             "rglru": ref.rglru_ref, "adamw": update_in_slices, "norm": ref.norm_ref}

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
                            ("recurrentgemma-9b", 3, 2100), ("qwen2-72b", 1, 256),
                            ("llama3-405b", 1, 256), ("granite-moe-1b-a400m", 2, 256),
                            ("phi3.5-moe-42b-a6.6b", 1, 256), ("whisper-small", 2, 256),
                            ("paligemma-3b", 2, 256), ("jamba2-3b", 8, 256)):
        # whisper: 2 decoder and 2 encoder layers over its 1500 frames;
        # paligemma: its 256 patches in front of the T tokens; jamba2-3b:
        # 7 mamba layers and its first attention layer.
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  dtype=torch.float32)
        if cfg.kind == "encdec":
            cfg = dataclasses.replace(cfg, enc_layers=layers)
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                            "cuda")
        gen = torch.Generator(device="cuda").manual_seed(2)
        toks = torch.randint(0, cfg.vocab, (1, T), device="cuda", generator=gen)
        extras = extra_inputs(cfg, 1, gen, "cuda")
        max_len = prefix_len(model, **extras) + T
        with torch.inference_mode():
            with_kernel, cache_k = model.prefill(toks, max_len, **extras)
            with_plain, cache_p = on_plain(lambda: model.prefill(toks, max_len,
                                                                 **extras))
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
        details.append(f"{arch} {layers}L T={T}{' +' + str(max_len - T) if max_len > T else ''}"
                       f" logits {werr:.3e}"
                       + (f" state {herr:.3e}" if cfg.pattern != ("attn",) else ""))
        del model, with_kernel, with_plain, cache_k, cache_p, extras
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

    # The same step for the recurrent archs (the scans' forward and backward
    # kernels against the plain scans under autograd), the MoE archs, whisper
    # (2 + 2 layers, 1500 frames), paligemma (256 patches + 256 tokens) and
    # jamba2-3b (8 layers: 7 mamba blocks with their FFNs, one attention).
    # The kernels' updated parameters and first moments wait on the host
    # while the plain step runs (recurrentgemma's 256000-row tables make two
    # f32 states too many for the card).
    for arch, layers in (("falcon-mamba-7b", 2), ("recurrentgemma-9b", 3),
                         ("granite-moe-1b-a400m", 2), ("phi3.5-moe-42b-a6.6b", 1),
                         ("whisper-small", 2), ("paligemma-3b", 2), ("jamba2-3b", 8)):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  dtype=torch.float32)
        if cfg.kind == "encdec":
            cfg = dataclasses.replace(cfg, enc_layers=layers)
        batch = synthetic_batch(4, cfg, 2, 256, "cuda")
        step1 = make_train_step(cfg, opt, num_microbatches=1)

        def fresh(cfg=cfg):
            return train_state_init(torch.Generator(device="cuda").manual_seed(3),
                                    cfg, opt, "cuda")

        sk, mk = step1(fresh(), batch)
        kmet = {key: float(mk[key]) for key in ("loss", "grad_norm")}
        kp = {n: p.detach().cpu() for n, p in sk["params"].named_parameters()}
        km = {n: m.cpu() for n, m in sk["opt"]["m"].items()}
        del sk, mk
        free()
        so, mo = on_plain(lambda: step1(fresh(), batch))
        for key in ("loss", "grad_norm"):
            check(abs(kmet[key] - float(mo[key])) <= 1e-3,
                  f"{arch} train step, kernels vs plain: {key} "
                  f"{float(mo[key])} vs {kmet[key]}")
        perr = max((p.detach() - kp[n].cuda()).abs().max().item()
                   for n, p in so["params"].named_parameters())
        check(perr <= 1e-3, f"{arch} train step, kernels vs plain: updated "
              f"parameters differ by {perr:.3e} > 1e-3")
        gerr = 0.0
        for n, m in so["opt"]["m"].items():
            rel = ((m - km[n].cuda()).norm() / m.norm().clamp(min=1e-30)).item()
            check(rel <= 1e-3, f"{arch} train step, kernels vs plain: "
                  f"gradient of {n} misses by {rel:.3e} of its norm")
            gerr = max(gerr, rel)
        details.append(
            f"{arch} {layers}L train step B=2 T=256: loss {kmet['loss']:.5f}, "
            f"kernels vs plain loss {abs(kmet['loss'] - float(mo['loss'])):.3e} "
            f"grad norm {abs(kmet['grad_norm'] - float(mo['grad_norm'])):.3e} "
            f"params {perr:.3e} gradients (relative, per leaf) {gerr:.3e}")
        del so, mo, kp, km, batch
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
        B, steps = int(argv[argv.index("--batch") + 1]), int(argv[argv.index("--steps") + 1])
        want = serve_launches(cfg, steps - 1)
        check(counts == want, f"{arch}: kernel launches {counts} in the main "
              f"path, expected one per layer of its type (and per encoder and "
              f"cross-attention layer) in prefill and every norm of prefill "
              f"and of {steps - 1} decode steps {want}")
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

    # These archs train through launch.train's own function: the recurrent
    # archs' scans' forward kernels (twice in a checkpointed layer) and
    # backward kernels, recurrentgemma's local layers through the flash
    # kernels at head dim 256; the MoE archs' experts through sort_scatter;
    # whisper's encoder, decoder and cross-attention and paligemma's patch
    # prefix through the flash kernels; then 3 more steps on one batch, where
    # the loss falls.  The MoE archs then take the loss and gradients of one
    # more step twice, which must agree bit for bit (AdamW is elementwise on
    # them, so the two steps would too): the dispatch and combine add in a
    # fixed order, forward and backward.
    for arch, argv in TRAIN_PATHS:
        reset_counts()
        tr = train_launch.run(argv)
        counts = read_counts()
        launches[f"{arch} train"] = counts
        cfg, n_steps = tr.cfg, len(tr.losses)
        leaves = local_leaves(tr.state["params"].parameters())
        B, T = int(argv[argv.index("--batch") + 1]), int(argv[argv.index("--seq") + 1])
        want = train_launches(cfg, n_steps, leaves)
        check(counts == want, f"{arch} train: kernel launches {counts}, "
              f"expected {want}")
        check(all(math.isfinite(x) for x in tr.losses),
              f"{arch} train: losses {tr.losses} not finite")
        reset_counts()
        step = make_train_step(cfg, tr.opt, num_microbatches=1)
        one = synthetic_batch(12, cfg, B, T, "cuda")
        state, mem_losses = tr.state, []
        for _ in range(MEMORIZE_STEPS):
            state, metrics = step(state, one)
            mem_losses.append(float(metrics["loss"]))
        counts = read_counts()
        launches[f"{arch} memorize"] = counts
        want = train_launches(cfg, MEMORIZE_STEPS, leaves)
        check(counts == want, f"{arch} memorize: kernel launches {counts}, "
              f"expected {want}")
        check(all(math.isfinite(x) for x in mem_losses)
              and mem_losses[-1] < mem_losses[0],
              f"{arch} memorize: losses {mem_losses} not finite and falling")
        phase(5, f"main path {arch} train",
              f"{cfg.n_layers} layers {str(cfg.dtype).removeprefix('torch.')} "
              f"B={B} T={T}, one microbatch, {n_steps} steps on fresh batches: "
              f"losses {', '.join(f'{x:.4f}' for x in tr.losses)}; step ms "
              f"{', '.join(f'{x:.3f}' for x in tr.step_ms)}; "
              f"{tr.tokens_per_s:.1f} tokens/s over steps 2..{n_steps}; peak "
              f"{tr.peak_bytes / 1e9:.3f} GB; launches "
              f"{launches[f'{arch} train']}; then {MEMORIZE_STEPS} steps on "
              f"one batch: losses {', '.join(f'{x:.4f}' for x in mem_losses)}; "
              f"launches {counts}")
        del step, metrics
        if cfg.is_moe:
            reset_counts()
            params = dict(state["params"].named_parameters())
            runs = []
            for _ in range(2):
                loss, aux = loss_fn(state["params"], one, cfg)
                grads = torch.autograd.grad(loss, list(params.values()))
                runs.append((loss.detach().cpu(), aux["moe_aux"].detach().cpu(),
                             [g.cpu() for g in grads]))
                del loss, aux, grads
            counts = read_counts()
            launches[f"{arch} twice"] = counts
            want = train_launches(cfg, 2, 0)
            check(counts == want, f"{arch} twice: kernel launches {counts}, "
                  f"expected {want}")
            (l1, a1, g1), (l2, a2, g2) = runs
            differ = [n for n, x, y in zip(params, g1, g2) if not torch.equal(x, y)]
            check(torch.equal(l1, l2) and torch.equal(a1, a2) and not differ,
                  f"{arch}: the same step twice gives losses {float(l1)!r}, "
                  f"{float(l2)!r}, aux {float(a1)!r}, {float(a2)!r}; gradients "
                  f"differ in {differ}")
            phase(5, f"main path {arch} determinism",
                  f"the loss ({float(l1):.6f}, MoE aux {float(a1):.6f}) and all "
                  f"{len(g1)} gradient leaves of one step, twice: bit-equal; "
                  f"launches {counts}")
            del params, runs, l1, a1, g1, l2, a2, g2
        del tr, one, state
        free()

    # Training: launch.train's own function, then one error-feedback int8
    # round over the gradients of one more loss on the trained state.
    reset_counts()
    ak.ELEMENTS = nk.ROWS = 0
    tr = train_launch.run(TRAIN_ARGS)
    counts = read_counts()
    launches["starcoder2-3b train"] = counts
    cfg, n_steps = tr.cfg, len(tr.losses)
    params = list(tr.state["params"].parameters())
    leaves = local_leaves(params)
    want = train_launches(cfg, n_steps, leaves)
    check(counts == want, f"starcoder2-3b train: kernel launches {counts}, "
          f"expected {want} (with remat, two forwards and one backward per "
          "layer and step; AdamW once a leaf a step)")
    n_params = sum(p.numel() for p in params)
    check(ak.ELEMENTS == n_steps * n_params, f"starcoder2-3b train: AdamW's "
          f"kernel updated {ak.ELEMENTS} elements, expected every parameter "
          f"each step, {n_steps} x {n_params}")
    B, T = (int(TRAIN_ARGS[TRAIN_ARGS.index(f) + 1]) for f in ("--batch", "--seq"))
    check(nk.ROWS == want["norm"] * B * T, f"starcoder2-3b train: the norm "
          f"kernel normalised {nk.ROWS} rows, expected every position of "
          f"every norm call, {want['norm']} x {B * T}")
    del params
    check(all(math.isfinite(x) for x in tr.losses),
          f"starcoder2-3b train: losses {tr.losses} not finite")
    phase(5, "main path starcoder2-3b train",
          f"{cfg.n_layers} layers {str(cfg.dtype).removeprefix('torch.')} "
          f"B=4 T=1024, {n_steps} steps on fresh batches: losses "
          f"{', '.join(f'{x:.4f}' for x in tr.losses)}; step ms "
          f"{', '.join(f'{x:.3f}' for x in tr.step_ms)}; "
          f"{tr.tokens_per_s:.1f} tokens/s over steps 2..{n_steps}; peak "
          f"{tr.peak_bytes / 1e9:.3f} GB; launches {counts}; AdamW's kernel "
          f"updated {n_steps} x {n_params} elements")

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
    want = train_launches(cfg, MEMORIZE_STEPS, leaves)
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
    want = dict(train_launches(cfg, 1, 0), quantize=len(grads))
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
    want = train_launches(cfg, CKPT_EXECUTED,
                          local_leaves(ck.state["params"].parameters()))
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
    want = train_launches(cfg, n_steps, model_leaves(cfg))
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
    want = train_launches(cfg, executed,
                          local_leaves(ex.state["params"].parameters()))
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

    run_mesh_phase(torch, launches, smi_line)
    free()
    finish_dryruns(dryruns)

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

    def flash_bwd_times(shape, seed: int, plain_iters: int):
        """The flash backward alone at ``shape`` (bf16, tensor cores), from
        one forward's saved tensors, against autograd of plain and of SDPA."""
        B, T, S, H, K, D, causal, window = shape
        q, k, v = (x.requires_grad_() for x in
                   attn_inputs(torch, shape, torch.bfloat16, seed=seed))
        dout = randn(torch, torch.Generator(device="cuda").manual_seed(seed + 1),
                     q.shape, torch.bfloat16)
        with torch.no_grad():
            o, lse, o_lo = fa._forward(q, k, v, causal, window, D ** -0.5,
                                       with_lse=True)
        path = fa.PATHS[fa.bwd_path(q.dtype, D, fa._aligned(q, k, v, dout))]
        want = fa.PATHS[2 if D in fa.WGMMA_BWD_TILES else 1]
        check(path == want, f"flash backward {shape}: path {path}, not {want}")
        groups = fa.bwd_groups(B, S, H, K, D)
        ms = time_ms(torch, lambda: fa.flash_attention_bwd_cuda(
            q, k, v, o, lse, dout, causal=causal, window=window, o_lo=o_lo),
            iters=10)
        plain_out = ref.attention_ref(q, k, v, causal=causal, window=window)
        plain_ms = time_ms(torch, lambda: torch.autograd.grad(
            plain_out, (q, k, v), dout, retain_graph=True), iters=plain_iters,
            warmup=1)
        del plain_out
        free()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True).transpose(1, 2)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            library_out, (q, k, v), dout, retain_graph=True), iters=10)
        flops = 10 * D * visible_pairs(T, S, causal, window) * B * H
        b_ms, b_by, detail = bound(flops, PEAK_BF16_FLOPS, 0,
                                   nbytes(q, k, v, o, dout, lse, q, k, v))
        del q, k, v, dout, o, lse, o_lo, qt, kt, vt, library_out
        free()
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=library_ms, path=path, groups=groups), (
            f"flash_attention backward bf16 {shape} ({path}, {groups} groups): "
            f"kernel {ms:.4f} ms ({ms / b_ms:.2f}x bound), plain (autograd) "
            f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms by {b_by} ({detail}; f32 CUDA-core bound "
            f"{flops / PEAK_F32_FLOPS * 1e3:.4f} ms)")

    times, lines = {}, []
    times["flash_attention"], line = flash_times(MAIN_SHAPE)
    lines.append(line)
    times["flash_local"], line = flash_times(LOCAL_SHAPE)
    lines.append(line)
    times["flash_train"], line = flash_times(TRAIN_SHAPE)
    lines.append(line)
    # whisper's encoder and paligemma's training shape, forward and backward.
    arch_times = {}
    for label, shape, seed in (("whisper_encoder", WHISPER_ENC_SHAPE, 87),
                               ("paligemma_train", PALI_TRAIN_SHAPE, 85)):
        fwd_t, line = flash_times(shape)
        lines.append(line)
        bwd_t, line = flash_bwd_times(shape, seed, plain_iters=3)
        lines.append(line)
        arch_times[label] = (shape, fwd_t, bwd_t)
    # The forward at the other head-dim 64 and 128 main shapes, and the
    # backward at those that train: whisper's cross-attention, granite's and
    # phi3.5's layers.
    fwd_times, bwd_times = {}, {}
    for label, shape in (("whisper_cross", WHISPER_CROSS_SHAPE),
                         ("llama3_prefill", LLAMA3_SHAPE),
                         ("phi3.5_prefill", PHI_SHAPE),
                         ("granite_prefill", GRANITE_SHAPE)):
        fwd_t, line = flash_times(shape)
        lines.append(line)
        fwd_times[label] = (shape, fwd_t)
    for label, shape, seed in (("whisper_cross", WHISPER_CROSS_SHAPE, 83),
                               ("granite_train", GRANITE_SHAPE, 81),
                               ("phi3.5_train", PHI_SHAPE, 79)):
        bwd_t, line = flash_bwd_times(shape, seed, plain_iters=3)
        lines.append(line)
        bwd_times[label] = (shape, bwd_t)

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
    check(path == "wgmma", f"flash backward {TRAIN_SHAPE}: path {path}, not wgmma")
    groups = fa.bwd_groups(B, S, H, K, D)
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

    # The scans' backward kernels at the training shapes, each call from one
    # forward's saved carries; plain is autograd's backward through the
    # plain scan (its graph built once).  The bound counts each input of the
    # backward read once (the forward's inputs, its carries, dy) and each
    # gradient written once.
    Bt, T, I, N, _ = SSM_TRAIN
    ins = ssm_inputs(torch, SSM_TRAIN, torch.bfloat16, seed=93)
    args = ss._prepare(*ins)
    with torch.no_grad():
        _, _, carries = ss._forward(*args, save=True)
    dy = randn(torch, torch.Generator(device="cuda").manual_seed(92),
               (Bt, T, I), torch.bfloat16)
    ms = time_ms(torch, lambda: ss.ssm_scan_bwd_cuda(dy, None, *args[:6], carries),
                 iters=10)
    grads = ss.ssm_scan_bwd_cuda(dy, None, *args[:6], carries)
    leaves = [t.clone().requires_grad_() for t in ins[:6]]
    y, _ = ref.ssm_scan_ref(*leaves)
    plain_ms = time_ms(torch, lambda: torch.autograd.grad(
        y, leaves, dy, retain_graph=True), iters=1, warmup=1)
    del y, leaves
    # per (b,t,i,n): the rebuilt state (dt*A, the h FMA, dt*B*x), g and q
    # (2 FMAs, 1 multiply), and the terms of dC, dB, ddt, dA, dx (about 13):
    # 20 flops and one exp.
    b_ms, b_by, detail = bound(Bt * T * I * N * 20, PEAK_F32_FLOPS,
                               Bt * T * I * N, nbytes(*args[:6], carries, dy, *grads))
    times["ssm_scan_bwd"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None)
    lines.append(f"ssm_scan backward x bf16 {SSM_TRAIN[:4]}: kernel {ms:.4f} ms "
                 f"({ms / b_ms:.2f}x bound), plain (autograd) {plain_ms:.4f} ms, "
                 f"bound {b_ms:.4f} ms by {b_by} ({detail}); no library call "
                 "computes a selective scan's gradient")
    del ins, args, carries, dy, grads
    free()

    B, T, L, _ = RGLRU_TRAIN
    ins = rglru_inputs(torch, RGLRU_TRAIN, torch.bfloat16, seed=91)
    args = rs._prepare(*ins)
    with torch.no_grad():
        _, _, carries = rs._forward(*args, 8.0, save=True)
    dh = randn(torch, torch.Generator(device="cuda").manual_seed(90),
               (B, T, L), torch.bfloat16)
    ms = time_ms(torch, lambda: rs.rglru_scan_bwd_cuda(dh, None, *args[:4], carries),
                 iters=20)
    grads = rs.rglru_scan_bwd_cuda(dh, None, *args[:4], carries)
    leaves = [t.clone().requires_grad_() for t in ins[:4]]
    hs, _ = ref.rglru_ref(*leaves)
    plain_ms = time_ms(torch, lambda: torch.autograd.grad(
        hs, leaves, dh, retain_graph=True), iters=1, warmup=1)
    del hs, leaves
    # per element: the 7 special functions of the gates (as the forward) and
    # one division in m'; about 30 flops around them.
    b_ms, b_by, detail = bound(B * T * L * 30, PEAK_F32_FLOPS, B * T * L * 8,
                               nbytes(*args[:4], carries, dh, *grads))
    times["rglru_scan_bwd"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None)
    lines.append(f"rglru_scan backward bf16 {RGLRU_TRAIN[:3]}: kernel {ms:.4f} ms "
                 f"({ms / b_ms:.2f}x bound), plain (autograd) {plain_ms:.4f} ms, "
                 f"bound {b_ms:.4f} ms by {b_by} ({detail}); no library call "
                 "computes an RG-LRU's gradient")
    del ins, args, carries, dh, grads
    free()

    # The flash backward at recurrentgemma's local training shape: head dim
    # 256 on the wgmma kernel.
    B, T, S, H, K, D, causal, window = LOCAL_TRAIN_SHAPE
    q, k, v = (x.requires_grad_() for x in
               attn_inputs(torch, LOCAL_TRAIN_SHAPE, torch.bfloat16, seed=89))
    dout = randn(torch, torch.Generator(device="cuda").manual_seed(88), q.shape,
                 torch.bfloat16)
    with torch.no_grad():
        o, lse, o_lo = fa._forward(q, k, v, causal, window, D ** -0.5,
                                   with_lse=True)
    path = fa.PATHS[fa.bwd_path(q.dtype, D, fa._aligned(q, k, v, dout))]
    check(path == "wgmma", f"flash backward {LOCAL_TRAIN_SHAPE}: path {path}, not wgmma")
    groups = fa.bwd_groups(B, S, H, K, D)
    ms = time_ms(torch, lambda: fa.flash_attention_bwd_cuda(
        q, k, v, o, lse, dout, causal=causal, window=window, o_lo=o_lo), iters=10)
    plain_out = ref.attention_ref(q, k, v, causal=causal, window=window)
    plain_ms = time_ms(torch, lambda: torch.autograd.grad(
        plain_out, (q, k, v), dout, retain_graph=True), iters=1, warmup=1)
    del plain_out
    free()
    qpos = torch.arange(T, device="cuda")[:, None] + (S - T)
    kpos = torch.arange(S, device="cuda")[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        library_out, (q, k, v), dout, retain_graph=True), iters=3, warmup=1)
    flops = 10 * D * visible_pairs(T, S, causal, window) * B * H
    b_ms, b_by, detail = bound(flops, PEAK_BF16_FLOPS, 0,
                               nbytes(q, k, v, o, dout, lse, q, k, v))
    times["flash_local_bwd"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=library_ms, path=path,
                                    groups=groups)
    lines.append(f"flash_attention backward bf16 {LOCAL_TRAIN_SHAPE} ({path}, "
                 f"{groups} groups): kernel {ms:.4f} ms ({ms / b_ms:.2f}x bound), "
                 f"plain (autograd) {plain_ms:.4f} ms, sdpa "
                 f"backward {library_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
                 f"({detail}; f32 CUDA-core bound "
                 f"{flops / PEAK_F32_FLOPS * 1e3:.4f} ms)")
    del q, k, v, dout, o, lse, o_lo, qt, kt, vt, mask, library_out
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

    # AdamW's update of phi3.5's stacked expert matrix, bf16 weights and
    # gradients, f32 moments: one read of p, g, m, v and one write of p, m, v.
    dtypes = ak.DTYPE_SETS[0]
    leaf = adamw_leaf(torch, ADAMW_MAIN, dtypes, seed=95)
    n = leaf[0].numel()
    ms = time_ms(torch, lambda: ak.adamw_cuda(*leaf, *scalars, **hyper, decay=True),
                 iters=10)
    plain_ms = time_ms(torch, lambda: update_in_slices(*leaf, *scalars, **hyper,
                                                        decay=True), iters=3, warmup=1)
    # Elementwise arithmetic, bound by bytes; one square root an element.
    b_ms, b_by, detail = bound(0, PEAK_F32_FLOPS, n,
                               nbytes(*leaf) + nbytes(leaf[0], *leaf[2:]))
    # PyTorch's fused AdamW is a yardstick only if it takes these dtypes;
    # the port never calls it.
    try:
        few = [t[0, 0, :8].clone() for t in leaf]
        torch._fused_adamw_([few[0]], [few[1]], [few[2]], [few[3]], [],
                            [torch.ones((), device="cuda")], lr=hyper["lr"],
                            beta1=hyper["b1"], beta2=hyper["b2"],
                            weight_decay=hyper["weight_decay"], eps=hyper["eps"],
                            amsgrad=False, maximize=False)
        torch.cuda.synchronize()
        library_note = ("torch._fused_adamw_ takes bf16 parameters with f32 "
                        "moments on this torch; not timed")
    except RuntimeError as e:
        library_note = f"torch._fused_adamw_ refuses these dtypes: {e}".splitlines()[0]
    times["adamw"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=None, library_note=library_note)
    lines.append(f"adamw {ADAMW_MAIN} bf16 / f32 moments: kernel {ms:.4f} ms, "
                 f"slice loop {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
                 f"({detail}); {library_note}")
    del leaf
    free()

    # The norms at starcoder2-3b's training shape, bf16 with the f32 scale
    # and bias: forward one read of x and one write of y (and a row's mean
    # and rstd), backward one read of x and dy and one write of dx (and the
    # f32 gradients of scale and bias); one rsqrt a row.  PyTorch's fused
    # F.layer_norm is the yardstick; the port never calls it.
    base, view, scale, bias, dy = norm_case(torch, NORM_MAIN, torch.bfloat16, seed=96)
    x, norm_kind = view(base), NORM_MAIN[-1]
    y, mean, rstd = nk.norm_fwd_cuda(x, scale, bias, norm_kind, 1e-6)
    g = nk.norm_bwd_cuda(dy, x, scale, mean, rstd, norm_kind)
    C, rows = x.shape[-1], x.numel() // x.shape[-1]
    with torch.no_grad():
        ms = time_ms(torch, lambda: nk.norm_fwd_cuda(x, scale, bias, norm_kind, 1e-6), iters=20)
        plain_ms = time_ms(torch, lambda: ref.norm_ref(x, scale, bias, norm_kind), iters=5)
        # F.layer_norm takes its weights in x's dtype on the card.
        sb, bb = scale.to(x.dtype), bias.to(x.dtype)
        library_ms = time_ms(torch, lambda: torch.nn.functional.layer_norm(
            x, (C,), sb, bb, 1e-6), iters=20)
    b_ms, b_by, detail = bound(0, PEAK_F32_FLOPS, rows, nbytes(x, scale, bias, y, mean, rstd))
    times["norm"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library_ms)
    lines.append(f"norm {norm_kind} bf16 {tuple(x.shape)}: kernel {ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms, F.layer_norm {library_ms:.4f} ms, bound "
                 f"{b_ms:.4f} ms by {b_by} ({detail})")
    ms = time_ms(torch, lambda: nk.norm_bwd_cuda(dy, x, scale, mean, rstd, norm_kind),
                 iters=20)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]

    def autograd_ms(fn):
        out = fn(*leaves)
        return time_ms(torch, lambda: torch.autograd.grad(out, leaves, dy,
                                                          retain_graph=True), iters=5)

    plain_ms = autograd_ms(lambda a, s_, b: ref.norm_ref(a, s_, b, norm_kind))
    library_ms = autograd_ms(lambda a, s_, b: torch.nn.functional.layer_norm(
        a, (C,), s_.to(a.dtype), b.to(a.dtype), 1e-6))
    b_ms, b_by, detail = bound(0, PEAK_F32_FLOPS, 0,
                               nbytes(x, dy, scale, mean, rstd, *g))
    times["norm_bwd"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms)
    lines.append(f"norm backward {norm_kind} bf16 {tuple(x.shape)}: kernels {ms:.4f} ms, "
                 f"autograd of plain {plain_ms:.4f} ms, of F.layer_norm "
                 f"{library_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({detail})")
    del base, x, scale, bias, dy, y, mean, rstd, g, leaves
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
        if name in ("flash_attention", "flash_attention_bwd"):
            for label, (shape, fwd_t, bwd_t) in arch_times.items():
                entry[f"at_{label}"] = dict(
                    shape=list(shape), max_abs_err=main_err[(name, shape)],
                    **(fwd_t if name == "flash_attention" else bwd_t))
        if name == "flash_attention":
            entry["shape"] = list(MAIN_SHAPE)
            for label, (shape, fwd_t) in fwd_times.items():
                entry[f"at_{label}"] = dict(
                    shape=list(shape), max_abs_err=main_err[(name, shape)], **fwd_t)
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
            entry["at_recurrentgemma_local_train"] = dict(
                shape=list(LOCAL_TRAIN_SHAPE), max_abs_err=main_err["flash_local_bwd"],
                **times["flash_local_bwd"])
            for label, (shape, bwd_t) in bwd_times.items():
                entry[f"at_{label}"] = dict(
                    shape=list(shape), max_abs_err=main_err[(name, shape)], **bwd_t)
        if name == "adamw":
            entry["note"] = ("replaces no TPU kernel: the reference's AdamW "
                             "(src/repro/train/optimizer.py) is jnp, fused by XLA; "
                             "plain is the optimizer's slice loop, which it "
                             "equals bit for bit")
            entry["shape"] = list(ADAMW_MAIN)
        if name in ("norm", "norm_bwd"):
            entry["note"] = ("replaces no TPU kernel: normalisation, which the JAX "
                             "package leaves to XLA's fusion (src/repro/models/"
                             "layers.py apply_norm, _qk_normalize); plain is the "
                             "f32 chain kernels.ref.norm_ref"
                             + ("; two launches a call: dx with per-block partial "
                                "sums, then their sum" if name == "norm_bwd" else ""))
            entry["shape"] = list(NORM_MAIN[1])
        if name in ("ssm_scan_bwd", "rglru_scan_bwd"):
            fwd = name.removesuffix("_bwd")
            entry["note"] = (f"the backward of the function {fwd}'s Pallas kernel "
                             "computes; the Pallas kernel has none, and the "
                             "reference differentiates its chunked jnp scan "
                             f"(src/repro/kernels/ops.py:"
                             f"{152 if fwd == 'ssm_scan' else 215})")
            entry["shape"] = list((SSM_TRAIN if fwd == "ssm_scan" else RGLRU_TRAIN)[:-1])
            entry["tiles"] = {k: getattr(m, k) for k in
                              ("CHUNK", "BWD_SEGMENT", "BWD_LANES", "BWD_CHANNELS",
                               "BWD_STAGES", "BWD_GROUP") if hasattr(m, k)}
        line.append(entry)
    print(smi_line, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training launcher: AdamW steps on synthetic token batches.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --layers 8 --batch 4 --seq 1024 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --tiny --device cpu --steps 20 --batch 8 --seq 64

Ported from ``repro.launch.train``.  Runs on the CUDA card unless
``--device cpu`` is given; ``--device cuda`` without a card raises.
Weights are random, drawn from ``--seed`` on the device, and each step
takes a fresh ``synthetic_batch``, as the reference's launcher does.
``--layers`` cuts the depth, every width stays the architecture's.  ``--tiny`` selects the architecture's
tiny test config in f32, as the reference launcher does.  Prints each
step's loss and ms, tokens/s and, on the card, the peak of
``torch.cuda.max_memory_allocated``, with the clocks read after a device
synchronize.  The first step also loads (and in a fresh checkout builds)
the CUDA kernels it runs.

On the card, architectures with mamba or RG-LRU blocks raise: the backward
kernels of their scans are not yet ported (their CPU training runs through
plain autograd).  ``--ckpt-every``, ``--fail-at`` and ``--mesh`` raise
``NotImplementedError`` until the checkpoint / BaseFS and distribution
slices bring them.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs.registry import ARCHS, get_config, tiny_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.serve import sync
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step, train_state_init


class TrainRun(NamedTuple):
    cfg: ModelConfig
    opt: AdamWConfig
    state: Dict                  # the final train state
    losses: List[float]          # per step
    step_ms: List[float]         # per step, host clock after a synchronize
    tokens_per_s: float          # over the steps after the first
    peak_bytes: Optional[int]    # torch.cuda.max_memory_allocated; None on CPU


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen3-32b", choices=sorted(ARCHS))
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config in f32 (CPU-scale smoke/bring-up)")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the architecture's)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = use the config's setting")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"])
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="simulate a host failure at this step")
    return ap.parse_args(argv)


def _refuse_unported(args: argparse.Namespace) -> None:
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training comes with the distribution "
            "slice (ROADMAP.md §1); run with --mesh none")
    if args.ckpt_every:
        raise NotImplementedError(
            "--ckpt-every: checkpoints through BaseFS come with the checkpoint "
            "/ BaseFS slice (ROADMAP.md §1)")
    if args.fail_at:
        raise NotImplementedError(
            "--fail-at: failure and elastic restart from a checkpoint come with "
            "the checkpoint / BaseFS slice (ROADMAP.md §1)")


def run(argv=None) -> TrainRun:
    args = parse_args(argv)
    _refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available; "
                           "pass --device cpu to run on the CPU")
    cfg = tiny_config(args.arch) if args.tiny else get_config(args.arch)
    if args.tiny:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    if args.layers is not None:
        if not 0 < args.layers <= cfg.n_layers:
            raise ValueError(f"--layers must be in 1..{cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if device.type == "cuda" and {"mamba", "rglru"} & set(cfg.pattern):
        raise NotImplementedError(
            f"{cfg.name} on the card: the backward kernels of the selective "
            "scan and the RG-LRU are not yet ported; train it with "
            "--device cpu")
    if min(args.steps, args.batch, args.seq) < 1:
        raise ValueError("--steps, --batch and --seq must be >= 1")
    mb = args.microbatches or cfg.microbatches
    print(f"arch={cfg.name} layers={cfg.n_layers} dtype={cfg.dtype} "
          f"params={cfg.params_total():,} batch={args.batch} seq={args.seq} "
          f"microbatches={mb} device={device}", flush=True)

    opt = AdamWConfig(lr=args.lr, state_dtype=cfg.opt_state_dtype)
    step_fn = make_train_step(cfg, opt, num_microbatches=mb)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = train_state_init(gen, cfg, opt, device)

    losses, step_ms = [], []
    for i in range(args.steps):
        batch = synthetic_batch(gen, cfg, args.batch, args.seq, device)
        sync(device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])            # waits for the step
        sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        print(f"step {i + 1:5d}  loss {loss:.4f}  grad_norm "
              f"{float(metrics['grad_norm']):.4f}  {step_ms[-1]:.3f} ms",
              flush=True)
    warm = step_ms[1:] or step_ms
    tok_s = args.batch * args.seq / (sum(warm) / len(warm) / 1e3)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None)
    print(f"train: {sum(warm) / len(warm):.3f} ms/step, {tok_s:.1f} tokens/s "
          f"over steps 2..{args.steps}" if len(step_ms) > 1 else
          f"train: {step_ms[0]:.3f} ms/step, {tok_s:.1f} tokens/s (one step)",
          flush=True)
    if peak is not None:
        print(f"peak device memory: {peak / 1e9:.3f} GB "
              "(torch.cuda.max_memory_allocated)", flush=True)
    return TrainRun(cfg, opt, state, losses, step_ms, tok_s, peak)


def main(argv: Optional[list] = None) -> int:
    run(argv)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

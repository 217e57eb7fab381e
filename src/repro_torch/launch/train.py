"""Training launcher: AdamW steps on synthetic token batches, with
checkpoints through the paper's consistency layers.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --layers 8 --batch 4 --seq 1024 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --tiny --device cpu --steps 20 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \\
        --layers 8 --batch 4 --seq 1024 --steps 3 --microbatches 1
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b \\
        --layers 3 --batch 4 --seq 1024 --steps 3 --microbatches 1
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
        --tiny --device cpu --steps 3 --batch 4 --seq 16
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --tiny --device cpu --steps 5 --ckpt-every 2 --fail-at 3 \\
        --consistency session --ckpt-hosts 4

Ported from ``repro.launch.train``.  Runs on the CUDA card unless
``--device cpu`` is given; ``--device cuda`` without a card raises.
Weights are random, drawn from ``--seed`` on the device.  Step ``i``'s batch
is a ``synthetic_batch`` drawn from ``(--seed, i)`` alone, as the reference
draws it from ``fold_in(PRNGKey(7), i)``, so a resumed run sees the batches
an uninterrupted one does.  ``--layers`` cuts the depth, every width stays
the architecture's.  ``--tiny`` selects the architecture's tiny test config
in f32, as the reference launcher does.  Prints each step's loss and ms,
tokens/s and, on the card, the peak of ``torch.cuda.max_memory_allocated``,
with the clocks read after a device synchronize.  The first step also loads
(and in a fresh checkout builds) the CUDA kernels it runs.

``--ckpt-every N`` saves the train state every N steps with a
:class:`repro_torch.checkpoint.CheckpointManager` over ``--consistency``
(``--ckpt-hosts`` writer hosts, each with a partner copy).  ``--fail-at K``
simulates a host failure after step K: the newest checkpoint is restored on
``ckpt_hosts - 1`` hosts with host 1's shards read from its partner copy,
and training resumes from that step (from a fresh state at step 0 if no
checkpoint exists yet).  Each save and the restore print their host wall
time.

Every architecture trains on the card: attention (self, encoder and
cross) through the flash kernels' forward and backward, and the mamba and
RG-LRU blocks through the scans' forward kernels and their CUDA backward
kernels (``csrc/ssm_scan_bwd.cu``, ``csrc/rglru_scan_bwd.cu``); on the CPU
all of them differentiate through the plain versions.  An audio or vision
arch's batches carry its stub frames or patches (``synthetic_batch``); an
MoE arch adds 0.01 times its load-balance loss and routes through
``sort_scatter`` (``a2a`` with a bound mesh, for granite).  The configs'
``microbatches`` (8, 16) size the reference's multi-chip step; on one card
pass ``--microbatches 1``.

``--mesh single|multi`` does what the reference's does: with fewer ranks
than the production mesh needs (256 single, 512 multi; the world size of a
process group already started, else of the torchrun environment, 1 without
one) it prints the reference's message and trains unsharded, with the same
numerics.  With enough ranks it starts the process group from the torchrun
environment unless one is started (``env://``; NCCL on the card, gloo on the
CPU), binds :func:`repro_torch.launch.mesh.make_production_mesh` and the
arch's rules, places the state and each batch on the mesh and runs the same
steps under :func:`repro_torch.models.sharding.active_rules`.  Checkpoints
of the sharded state are saved and restored as the reference's are: every
rank takes part, rank 0 writes and reads, and the bytes are an unsharded
save's (:class:`repro_torch.checkpoint.CheckpointManager`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import ARCH_NAMES, get_config, tiny_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch import mesh as MS
from repro_torch.launch.serve import resolve_device, sync
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import active_rules
from repro_torch.models.transformer import init_params
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step, train_state_init


class TrainRun(NamedTuple):
    cfg: ModelConfig
    opt: AdamWConfig
    state: Dict                  # the final train state
    losses: List[float]          # per step executed, replays included, in order
    step_ms: List[float]         # the same, host clock after a synchronize
    tokens_per_s: float          # over the steps after the first
    peak_bytes: Optional[int]    # torch.cuda.max_memory_allocated; None on CPU
    ckpt: Optional[CheckpointManager]  # None without --ckpt-every
    ckpt_steps: List[int]        # the step of each save, in order
    replayed: List[int]          # steps executed again after the restart
    save_ms: List[float]         # host wall time of each save
    restore_ms: List[float]      # host wall time of the restore, if any


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen3-32b", choices=ARCH_NAMES)
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
    ap.add_argument("--consistency", default="session",
                    choices=["commit", "session", "posix", "mpiio"])
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-hosts", type=int, default=4)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="simulate a host failure at this step")
    return ap.parse_args(argv)


def batch_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s batch: a function of (seed, step) alone."""
    return int(np.random.SeedSequence((seed, step)).generate_state(1)[0])


def config_from_args(args: argparse.Namespace) -> ModelConfig:
    """The arch's config (``--tiny``: its tiny config in f32), cut to
    ``--layers``."""
    cfg = tiny_config(args.arch) if args.tiny else get_config(args.arch)
    if args.tiny:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    if args.layers is not None:
        if not 0 < args.layers <= cfg.n_layers:
            raise ValueError(f"--layers must be in 1..{cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def bind_mesh(args: argparse.Namespace, cfg: ModelConfig, device: torch.device):
    """(mesh, rules) for ``--mesh``, or (None, None): unsharded, with the
    reference's message when the world is smaller than the mesh."""
    if args.mesh == "none":
        return None, None
    need = 512 if args.mesh == "multi" else 256
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world < need:
        print(f"[launch] {need} devices required for --mesh {args.mesh}, "
              f"have {world}; running unsharded (same numerics).", flush=True)
        return None, None
    if not torch.distributed.is_initialized():
        torch.distributed.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", init_method="env://")
    multi = args.mesh == "multi"
    return (MS.make_production_mesh(multi_pod=multi, device_type=device.type),
            MS.arch_rules(cfg, multi))


def run(argv=None) -> TrainRun:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    if min(args.steps, args.batch, args.seq, args.ckpt_hosts) < 1:
        raise ValueError("--steps, --batch, --seq and --ckpt-hosts must be >= 1")
    if min(args.ckpt_every, args.fail_at) < 0:
        raise ValueError("--ckpt-every and --fail-at must be >= 0")
    mb = args.microbatches or cfg.microbatches
    print(f"arch={cfg.name} layers={cfg.n_layers} dtype={cfg.dtype} "
          f"params={cfg.params_total():,} batch={args.batch} seq={args.seq} "
          f"microbatches={mb} device={device}", flush=True)

    mesh, rules = bind_mesh(args, cfg, device)
    opt = AdamWConfig(lr=args.lr, state_dtype=cfg.opt_state_dtype)
    step_fn = make_train_step(cfg, opt, num_microbatches=mb)
    if mesh is not None:
        unsharded_step = step_fn

        def step_fn(state, batch):
            with active_rules(rules, mesh):
                return unsharded_step(state, MS.distribute_batch(batch, mesh, rules))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def fresh_state():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        if mesh is None:
            return train_state_init(gen, cfg, opt, device)
        return MS.sharded_train_state(init_params(cfg, gen, device), cfg, opt,
                                      mesh, rules)

    mgr = (CheckpointManager(model=args.consistency, num_hosts=args.ckpt_hosts,
                             partner=True) if args.ckpt_every else None)
    losses, step_ms, save_ms, restore_ms = [], [], [], []
    ckpt_steps, replayed = [], []
    fail_at, done = args.fail_at, 0      # done: the highest step completed
    state, start = fresh_state(), 0
    while True:
        failed = False
        for i in range(start, args.steps):
            batch = synthetic_batch(batch_seed(args.seed, i), cfg, args.batch,
                                    args.seq, device)
            sync(device)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])            # waits for the step
            sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            last = i + 1
            if last <= done:
                replayed.append(last)
            done = max(done, last)
            print(f"step {last:5d}  loss {loss:.4f}  grad_norm "
                  f"{float(metrics['grad_norm']):.4f}  {step_ms[-1]:.3f} ms",
                  flush=True)
            if mgr is not None and last % args.ckpt_every == 0:
                t0 = time.perf_counter()
                manifest = mgr.save(last, state)
                save_ms.append((time.perf_counter() - t0) * 1e3)
                ckpt_steps.append(last)
                gb = sum(p["nbytes"] for leaf in manifest["leaves"].values()
                         for p in leaf["parts"]) / 1e9
                print(f"step {last:5d}  checkpoint saved ({args.consistency}, "
                      f"{args.ckpt_hosts} hosts + partner copies, {gb:.3f} GB "
                      f"a copy) in {save_ms[-1]:.3f} ms", flush=True)
            if fail_at and last == fail_at:
                failed = True
                break
        if not failed:
            break
        fail_at = 0
        del metrics
        if mgr is None or not mgr.manifests:
            print(f"[launch] host failure at step {last} before the first "
                  "checkpoint; restart from step 0", flush=True)
            state = None                 # the card never holds two states
            state, start = fresh_state(), 0
            continue
        ck = max(mgr.manifests)
        t0 = time.perf_counter()
        restored = mgr.restore(ck, state, num_hosts_new=args.ckpt_hosts - 1,
                               failed_hosts=[1])
        sync(device)
        restore_ms.append((time.perf_counter() - t0) * 1e3)
        state, start = restored, ck      # drops the failed run's state
        print(f"[launch] host failure at step {last}; elastic restart from "
              f"checkpoint {ck} on {args.ckpt_hosts - 1} hosts (partner copy) "
              f"in {restore_ms[-1]:.3f} ms", flush=True)

    warm = step_ms[1:] or step_ms
    tok_s = args.batch * args.seq / (sum(warm) / len(warm) / 1e3)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None)
    print(f"train: {sum(warm) / len(warm):.3f} ms/step, {tok_s:.1f} tokens/s "
          f"over executed steps 2..{len(step_ms)}" if len(step_ms) > 1 else
          f"train: {step_ms[0]:.3f} ms/step, {tok_s:.1f} tokens/s (one step)",
          flush=True)
    if peak is not None:
        print(f"peak device memory: {peak / 1e9:.3f} GB "
              "(torch.cuda.max_memory_allocated)", flush=True)
    return TrainRun(cfg, opt, state, losses, step_ms, tok_s, peak, mgr,
                    ckpt_steps, replayed, save_ms, restore_ms)


def main(argv: Optional[list] = None) -> int:
    run(argv)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

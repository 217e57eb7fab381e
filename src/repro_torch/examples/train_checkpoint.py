"""End-to-end example: train a ~100M decoder LM with consistency-aware
checkpointing, kill a host mid-run, and resume from the partner copy on a
DIFFERENT host count (elastic restart).

    PYTHONPATH=src python -m repro_torch.examples.train_checkpoint \\
        [--steps 300] [--d-model 768] [--layers 12] [--model session] \\
        [--device cuda]

Ported from the reference's ``examples/train_checkpoint.py``, with its
flags, defaults and data flow.  The default model is ~100M parameters
(d=768, 12L, ff=3072, vocab 8192), in f32.  On the CPU pass ``--device cpu
--steps 12 --d-model 256 --layers 4`` for a quick demo; the code path is
identical.  Data flows PreloadedStore -> TokenPipeline -> train_step, i.e.
every training token moved through the burst-buffer consistency layer, and
checkpoints move through CheckpointManager on the same layer.  The corpus
is drawn from :data:`SAMPLE_SEED`, the int the reference derives from its
``PRNGKey(0)``, so both examples read the same tokens.  :func:`main`
returns an :class:`ExampleRun` for callers that check the run.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.costmodel import CostModel
from repro_torch.data.dlio import PreloadedStore
from repro_torch.data.pipeline import TokenPipeline, make_token_samples
from repro_torch.launch.serve import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step, train_state_init

#: ``int(jax.random.randint(PRNGKey(0), (), 0, 2**31 - 1))``: the seed of the
#: reference example's corpus.
SAMPLE_SEED = 31327077


class ExampleRun(NamedTuple):
    cfg: ModelConfig
    state: Dict                  # the final train state
    losses: List[float]          # per step executed, in order
    fail_step: int               # the step after which host 1 failed
    restored_step: int           # the checkpoint the restart resumed from
    ckpt_steps: List[int]        # the step of each save, in order
    mgr: CheckpointManager
    ckpt_bandwidth: Optional[float]  # mean modelled save bandwidth, B/s


def build_cfg(args) -> ModelConfig:
    return ModelConfig(
        name="example-lm",
        kind="decoder",
        n_layers=args.layers,
        d_model=args.d_model,
        n_heads=max(args.d_model // 64, 1),
        n_kv_heads=max(args.d_model // 128, 1),
        d_ff=4 * args.d_model,
        vocab=8192,
        dtype=torch.float32,
        policy="dp",
    )


def main(argv=None) -> ExampleRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--model", default="session",
                    choices=["commit", "session", "posix", "mpiio"])
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = build_cfg(args)
    print(f"model: {cfg.params_total()/1e6:.1f}M params, "
          f"consistency={args.model}, hosts={args.hosts}")

    # ---- data: preloaded burst-buffer shards ---------------------------
    n_samples = 64
    samples = make_token_samples(SAMPLE_SEED, n_samples, args.seq + 1,
                                 cfg.vocab)
    store = PreloadedStore(args.model, num_hosts=args.hosts,
                           samples_per_host=n_samples // args.hosts,
                           procs_per_host=1, samples=samples)
    store.preload()
    pipe = TokenPipeline(store, cfg, batch_size=args.batch, seq=args.seq,
                         device=device)

    # ---- training state + checkpoint manager ---------------------------
    opt = AdamWConfig(lr=1e-3)
    state = train_state_init(torch.Generator(device=device).manual_seed(1),
                             cfg, opt, device)
    step = make_train_step(cfg, opt)
    mgr = CheckpointManager(model=args.model, num_hosts=args.hosts,
                            partner=True, fs=store.fs)
    losses: List[torch.Tensor] = []
    ckpt_steps: List[int] = []

    fail_at = args.steps // 2
    i, epoch = 0, 0
    last_ckpt = 0
    t0 = time.time()
    while i < fail_at:
        for batch in pipe.batches(epoch):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
            i += 1
            if i % 10 == 0:
                print(f"step {i:4d}  loss {float(metrics['loss']):.4f}  "
                      f"({(time.time()-t0)/i:.2f}s/step)")
            if i % args.ckpt_every == 0:
                mgr.save(i, state)
                ckpt_steps.append(i)
                last_ckpt = i
                print(f"step {i:4d}  checkpointed (level-1, partner copy)")
            if i >= fail_at:
                break
        epoch += 1
    if last_ckpt == 0:
        mgr.save(i, state)
        ckpt_steps.append(i)
        last_ckpt = i
    fail_step = i

    # ---- simulated failure: host 1 dies; elastic resume on hosts-1 -----
    print(f"\n*** host 1 fails at step {i}; resuming step {last_ckpt} "
          f"checkpoint on {args.hosts - 1} hosts (partner copy) ***\n")
    state = mgr.restore(last_ckpt, state,
                        num_hosts_new=args.hosts - 1, failed_hosts=[1])
    i = last_ckpt

    while i < args.steps:
        for batch in pipe.batches(epoch):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
            i += 1
            if i % 10 == 0:
                print(f"step {i:4d}  loss {float(metrics['loss']):.4f}")
            if i >= args.steps:
                break
        epoch += 1

    mgr.save(args.steps, state)
    ckpt_steps.append(args.steps)
    mgr.flush(args.steps)     # level-2: drain to the underlying PFS
    print(f"\nfinal loss {float(metrics['loss']):.4f} after {i} steps "
          "(1 failure, elastic restart)")

    # ---- I/O accounting through the DES --------------------------------
    phases = CostModel().replay(store.fs.ledger)
    ck = [p for p in phases if p.name.startswith("ckpt_save")]
    bw = None
    if ck:
        bw = sum(p.io_bandwidth for p in ck) / len(ck)
        print(f"mean modeled checkpoint bandwidth: {bw/1e9:.2f} GB/s "
              f"({len(ck)} checkpoints, {args.model} consistency)")
    return ExampleRun(cfg, state, [float(x) for x in losses], fail_step,
                      last_ckpt, ckpt_steps, mgr, bw)


if __name__ == "__main__":
    main()

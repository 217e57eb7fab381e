"""Quickstart: build a model, train a few steps, generate, checkpoint.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Ported from the reference's ``examples/quickstart.py``.  On the CPU it runs
in seconds.  The same ``--arch`` ids and code paths scale to full width on
the card via ``repro_torch.launch.train``.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import tiny_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.serve import resolve_device
from repro_torch.serve.decode import generate
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step, train_state_init


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)

    # Any of the ported architectures; tiny variants run on CPU.
    cfg = dataclasses.replace(tiny_config("qwen3-32b"), dtype=torch.float32)
    print(f"arch: {cfg.name}  params: {cfg.params_total():,}")

    opt = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    state = train_state_init(torch.Generator(device=device).manual_seed(0),
                             cfg, opt, device)
    step = make_train_step(cfg, opt)
    batch = synthetic_batch(1, cfg, batch=8, seq=32, device=device)

    for i in range(10):
        state, metrics = step(state, batch)
        if i % 3 == 0:
            print(f"step {i}: loss {float(metrics['loss']):.4f}")

    # Greedy generation with the KV cache.
    prompt = batch["tokens"][:1, :8]
    out = generate(state["params"], prompt, steps=8)
    print("generated tokens:", out[0].tolist())

    # Checkpoint through the paper's session-consistency layer and restore.
    mgr = CheckpointManager(model="session", num_hosts=4)
    mgr.save(10, state)
    restored = mgr.restore(10, state)
    same = all(
        torch.equal(a, b)
        for a, b in zip(state["params"].parameters(),
                        restored["params"].parameters()))
    print(f"checkpoint roundtrip exact: {same}")


if __name__ == "__main__":
    main()

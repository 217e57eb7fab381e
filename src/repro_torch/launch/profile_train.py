"""Where a train step's time goes: a torch.profiler breakdown.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        --arch whisper-small --batch 4 --seq 448 --microbatches 1

Takes the arguments of ``repro_torch.launch.train`` that shape a step
(``--arch``, ``--tiny``, ``--layers``, ``--batch``, ``--seq``,
``--microbatches``, ``--lr``, ``--seed``, ``--device``); ``--steps`` is the
number of warm-up steps (kernel build, cuBLAS plans, allocator) before the
profiled one.  All steps take one batch, ``launch.train``'s first.  Prints
the profiled step's wall time (after a device synchronize), the device's
busy and idle share (summed kernel time over wall time; kernels run on one
stream), the time of the step's phases (forward, backward, optimizer) and
of the port's other spans, and the kernels that took the most device
time, as ``launch.profile_serve`` does for serving.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.profile_serve import report
from repro_torch.launch.serve import resolve_device, sync
from repro_torch.launch.train import batch_seed, config_from_args, parse_args
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step, train_state_init


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    mb = args.microbatches or cfg.microbatches
    print(f"arch={cfg.name} layers={cfg.n_layers} dtype={cfg.dtype} "
          f"batch={args.batch} seq={args.seq} microbatches={mb} "
          f"warm-up steps={args.steps} device={device}", flush=True)
    opt = AdamWConfig(lr=args.lr, state_dtype=cfg.opt_state_dtype)
    step = make_train_step(cfg, opt, num_microbatches=mb)
    state = train_state_init(torch.Generator(device=device).manual_seed(args.seed),
                             cfg, opt, device)
    batch = synthetic_batch(batch_seed(args.seed, 0), cfg, args.batch,
                            args.seq, device)
    for _ in range(args.steps):
        state, metrics = step(state, batch)
        float(metrics["loss"])
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        sync(device)
        wall = time.perf_counter() - t0
    print(f"loss {loss:.4f}", flush=True)
    report(prof, "train step", wall, device, top=15)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

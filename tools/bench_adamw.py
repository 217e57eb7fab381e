#!/usr/bin/env python3
"""Time the port's AdamW update over every leaf of a benchmark cell's model on one CUDA card.

    python3 tools/bench_adamw.py [--configs starcoder2-3b phi35moe-3l] [--iters 5]

For each configuration under ``chipbench/configs/``, makes its parameter
leaves on the card in the configuration's dtypes (weights and gradients in
``dtype``, moments in ``opt_state_dtype``, as a train cell with one
microbatch holds them; values from a fixed seed), then times, by CUDA
events over ``--iters`` calls after one warm-up, the fused kernel
(``kernels.adamw.adamw_cuda``) over all leaves, the slice loop
(``train.optimizer.update_in_slices``) over all leaves, ``global_norm``
alone, and ``adamw_update`` whole (the optimizer phase of a train step on
the card); the kernel's device time from one more pass under
``torch.profiler``; and gives the bound: one read of p, g, m, v and one
write of p, m, v at 3.35 TB/s.  ``chip_smoke.py`` holds the kernel to the
slice loop's bits and counts its launches on the main path.

Prints the card's name and power limit, a line per configuration, then one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12


def events_ms(torch, fn, iters: int) -> float:
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


def device_ms(torch, fn) -> float:
    """Device time of the kernels one call of ``fn`` launches."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / 1e3


def leaves(torch, cfg, seed: int):
    """Parameters, gradients and AdamW state of ``cfg``'s model on the card."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import optimizer as TO
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    shapes = {n: p.shape for n, p in Transformer(cfg, device="meta").named_parameters()}
    params = {n: draw(s, 0.02, cfg.dtype) for n, s in shapes.items()}
    grads = {n: draw(s, 1e-3, cfg.dtype) for n, s in shapes.items()}
    state = TO.adamw_init(params, TO.AdamWConfig(state_dtype=cfg.opt_state_dtype))
    for n in shapes:
        state["m"][n].copy_(draw(shapes[n], 1e-4, torch.float32))
        state["v"][n].copy_(draw(shapes[n], 1e-4, torch.float32) ** 2)
    state["step"].fill_(1)
    return params, grads, state


def bench(torch, name: str, iters: int) -> dict:
    from chipbench.kinds.train import port_config
    from repro_torch.kernels import accounting as acc
    from repro_torch.kernels import adamw as AK
    from repro_torch.train import optimizer as TO
    cfg = port_config(json.loads((ROOT / "chipbench" / "configs" / f"{name}.json")
                                 .read_text())["model"])
    params, grads, state = leaves(torch, cfg, seed=7)
    opt = TO.AdamWConfig(state_dtype=cfg.opt_state_dtype)
    hyper = dict(lr=opt.lr, b1=opt.b1, b2=opt.b2, eps=opt.eps,
                 weight_decay=opt.weight_decay)
    n_params = sum(p.numel() for p in params.values())
    moved = sum(acc.nbytes(params[n], grads[n], state["m"][n], state["v"][n])
                + acc.nbytes(params[n], state["m"][n], state["v"][n]) for n in params)

    gnorm = TO.global_norm(grads)
    clip = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    f32 = dict(dtype=torch.float32, device="cuda")
    stepf = torch.tensor(2.0, **f32)
    bc1 = 1 - torch.tensor(opt.b1, **f32) ** stepf
    bc2 = 1 - torch.tensor(opt.b2, **f32) ** stepf
    quads = [(params[n], grads[n], state["m"][n], state["v"][n], params[n].ndim >= 2)
             for n in params]

    def over_leaves(update):
        def run():
            for p, g, m, v, decay in quads:
                update(p, g, m, v, clip, bc1, bc2, **hyper, decay=decay)
        return run

    out = {"config": name, "leaves": len(quads), "params": n_params,
           "bytes_moved": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
           "kernel_device_ms": device_ms(torch, over_leaves(AK.adamw_cuda)),
           "kernel_ms": events_ms(torch, over_leaves(AK.adamw_cuda), iters),
           "slices_ms": events_ms(torch, over_leaves(TO.update_in_slices), iters),
           "global_norm_ms": events_ms(torch, lambda: TO.global_norm(grads), iters),
           "update_ms": events_ms(torch, lambda: TO.adamw_update(grads, state, params,
                                                                 opt), iters)}
    out["kernel_roofline_pct"] = 100 * out["bound_ms"] / out["kernel_device_ms"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="+", default=["starcoder2-3b", "phi35moe-3l"])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_adamw: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    torch.set_grad_enabled(False)
    results = []
    for name in args.configs:
        torch.cuda.reset_peak_memory_stats()
        r = bench(torch, name, args.iters)
        results.append(r)
        print(f"{name}: {r['leaves']} leaves, {r['params']:,} parameters; kernel "
              f"{r['kernel_ms']:.3f} ms ({r['kernel_device_ms']:.3f} device, bound "
              f"{r['bound_ms']:.3f}: {r['kernel_roofline_pct']:.1f}%), slice loop "
              f"{r['slices_ms']:.3f}, global_norm {r['global_norm_ms']:.3f}, "
              f"adamw_update {r['update_ms']:.3f}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi.stdout.strip(), "configs": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

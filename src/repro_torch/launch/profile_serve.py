"""Where the serving path's time goes: a torch.profiler breakdown.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch qwen3-32b \\
        --layers 8 --batch 4 --prompt-len 1024 --steps 32

Takes the arguments of ``repro_torch.launch.serve`` (every arch, with its
frames or patches).  Runs the batch once to
warm up (kernel build, cuBLAS plans, allocator), then once more with a
profiler window around prefill and another around the decode steps.  For
each window it prints the wall time (after a device synchronize), the
device's busy and idle share (summed kernel time over wall time; kernels
run on one stream), the time of each of the port's spans
(:func:`span_rows`) and the kernels that took the most device time.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.launch.serve import parse_args, serve_batch, setup, sync
from repro_torch.serve.decode import make_prefill, make_serve_step, prefix_len


def report(prof, name: str, wall_s: float, device: torch.device,
           top: int = 12) -> None:
    on_device = device.type == "cuda"
    key = "self_device_time_total" if on_device else "self_cpu_time_total"
    # The spans' own rows (on the card, their device-side copies too) would
    # count their ops' time again; span_rows prints them apart.
    rows = [e for e in prof.key_averages()
            if getattr(e, key) > 0 and not e.is_user_annotation]
    rows.sort(key=lambda e: getattr(e, key), reverse=True)
    # Host ops report the time of the kernels they launched as their own
    # "self device" time; keep the kernels' own entries so none counts twice.
    if on_device:
        rows = [e for e in rows
                if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(e, key) for e in rows)
    where = "device" if on_device else "host (no CUDA device: host op times)"
    print(f"== {name}: wall {wall_s * 1e3:.3f} ms; {where} busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e6 / wall_s * 100:.1f}% of wall)")
    # A span's share: of the device's busy time, or on the host of the wall
    # time (its host time holds the Python between its ops).
    whole_ms = busy_us / 1e3 if on_device else wall_s * 1e3
    for ms, what in span_rows(prof, on_device):
        print(f"  {ms:10.3f} ms {ms / max(whole_ms, 1e-9) * 100:6.1f}%  {what}")
    for e in rows[:top]:
        t = getattr(e, key)
        print(f"  {t / 1e3:10.3f} ms {t / max(busy_us, 1e-9) * 100:6.1f}% "
              f"{e.count:6d}x  {e.key[:100]}")


def span_rows(prof, on_device: bool) -> List[Tuple[float, str]]:
    """(ms, label) of each of the port's spans (:mod:`repro_torch.obs`).
    On the card, the device time of what was launched inside it
    (:func:`obs.split`): by train phase (``phase ...``, ``none`` outside
    them), then by innermost span; on the CPU its host time, children
    included, from ``key_averages()``."""
    if not on_device:
        return [(e.cpu_time_total / 1e3, f"span {e.key} ({e.count}x, host)")
                for e in prof.key_averages() if e.key.startswith(obs.PREFIX)]
    r = obs.split(prof.profiler.kineto_results.events())
    rows = []
    if set(r["phase_s"]) - {"none"}:
        rows += [(s * 1e3, f"phase {p}") for p, s in sorted(r["phase_s"].items())]
    rows += [(s * 1e3, f"span {n} ({r['span_launches'][n]} ops)")
             for n, s in sorted(r["span_s"].items())
             if n != "none" and not n.startswith(obs.PHASE)]
    return rows


@torch.inference_mode()
def main(argv=None) -> int:
    args = parse_args(argv)
    model, prompt, extras = setup(args)
    device = prompt.device
    serve_batch(model, prompt, args.steps, extras)    # warm-up run

    start = prefix_len(model, **extras) + prompt.shape[1]
    prefill = make_prefill(model, start + args.steps)
    step = make_serve_step(model)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    sync(device)
    with profile(activities=activities) as p_pre:
        t0 = time.perf_counter()
        tok, _, cache = prefill(prompt, **extras)
        sync(device)
        t_pre = time.perf_counter() - t0
    with profile(activities=activities) as p_dec:
        t0 = time.perf_counter()
        for i in range(args.steps - 1):
            tok, _, cache = step(cache, tok[:, None], start + i)
        sync(device)
        t_dec = time.perf_counter() - t0
    report(p_pre, "prefill", t_pre, device)
    report(p_dec, f"decode ({args.steps - 1} steps)", t_dec, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Time the port's norm kernels at the benchmark cells' shapes on one CUDA card.

    python3 tools/bench_norm.py [--iters 20]

For each normalisation a train step of a cell under ``chipbench/configs/``
runs (its ``d_model`` norms, and Jamba's dt / B / C norms as views of the
mixer's projection, and any qk-norm heads), makes the input on the card in
the cell's dtype from a fixed seed, then times, by CUDA events over
``--iters`` calls after one warm-up:

* the kernels (``kernels.norm``): the forward, and the backward alone
  (``norm_bwd_cuda`` from the forward's statistics);
* the plain chain (``kernels.ref.norm_ref``), forward, and its autograd
  backward;
* PyTorch's fused ``F.layer_norm`` / ``F.rms_norm``, forward and backward,
  as a yardstick only (the port never calls them);

and the kernels' device time of one call under ``torch.profiler``, beside
the bound: the bytes of one read of each input and one write of each
output (``kernels.accounting``'s count) at 3.35 TB/s.  Then, for each train
cell, the device ms of all its norms a step (forward, the recompute of the
checkpointed layers, backward) through the kernels and through the chain,
and for the prefill cell the forward norms of a batch at each prompt
length.  A second backward call must give the same bits.  ``chip_smoke.py``
holds the kernels to the plain chain and counts their launches on the
main paths.

Prints the card's name and power limit, a line per shape and per cell,
then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12
# cell: (configuration, batch, sequence lengths, train)
CELLS = {"starcoder2-train-2k": ("starcoder2-3b", 4, (2048,), True),
         "phi35moe-train-4k": ("phi35moe-3l", 4, (4096,), True),
         "jamba2-3b-train-8k": ("jamba2-3b", 2, (8192,), True),
         "starcoder2-prefill-1k4k": ("starcoder2-3b", 4, (1024, 2048, 4096), False)}


def step_norms(m: dict, B: int, T: int) -> list:
    """The norms of one step of model ``m`` at (B, T): dicts of ``what``,
    ``shape`` (the normalised view), ``base`` (the tensor it is a view of),
    ``cols`` (the view's columns of base's last dim), ``kind``, ``bias``,
    ``fwd`` (forward calls a train step, the checkpointed layers' recompute
    included), ``bwd`` (backward calls a train step) and ``prefill`` (calls
    of a prefill over the whole prompt; its final norm takes the last
    position alone, left out)."""
    pattern = m.get("pattern", ["attn"])
    L, P, D = m["n_layers"], len(pattern), m["d_model"]
    ckpt = (L // P) * P if m.get("remat") else 0
    types = [pattern[i % P] for i in range(L)]
    kind, out = m["norm"], []

    def add(what, shape, kind, calls_fwd, calls_bwd, prefill, base=None, cols=None):
        out.append(dict(what=what, shape=shape, base=base or shape,
                        cols=cols or (0, shape[-1]), kind=kind,
                        bias=kind == "layernorm", fwd=calls_fwd, bwd=calls_bwd,
                        prefill=prefill))

    per_layer = [2 if t != "mamba" or m.get("mamba_ffn") else 1 for t in types]
    twice = [2 if i < ckpt else 1 for i in range(L)]
    add("d_model", (B, T, D), kind, sum(n * k for n, k in zip(per_layer, twice)) + 1,
        sum(per_layer) + 1, sum(per_layer))
    mamba = [i for i, t in enumerate(types) if t == "mamba"]
    if mamba and m.get("mamba_dt_bc_norm"):
        R, N = m["dt_rank"], m["ssm_state"]
        calls = (sum(twice[i] for i in mamba), len(mamba), len(mamba))
        for what, cols in (("dt", (0, R)), ("B", (R, R + N)), ("C", (R + N, R + 2 * N))):
            add(what, (B, T, cols[1] - cols[0]), "rmsnorm", *calls,
                base=(B, T, R + 2 * N), cols=cols)
    attn = [i for i, t in enumerate(types) if t in ("attn", "local")]
    if attn and m.get("qk_norm"):
        hd = m.get("d_head", D // m["n_heads"])
        calls = (sum(twice[i] for i in attn), len(attn), len(attn))
        add("q_norm", (B, T, m["n_heads"], hd), "rmsnorm", *calls)
        add("k_norm", (B, T, m["n_kv_heads"], hd), "rmsnorm", *calls)
    return out


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
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / 1e3


def bench_shape(torch, n: dict, dtype, iters: int) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import accounting as acc
    from repro_torch.kernels import norm as NK
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(7)
    base = (torch.randn(n["base"], generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    x = base[..., n["cols"][0]:n["cols"][1]]
    C, kind = x.shape[-1], n["kind"]
    scale = 1 + 0.1 * torch.randn(C, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(C, generator=gen, device="cuda") if n["bias"] else None
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    eps = 1e-6

    y, mean, rstd = NK.norm_fwd_cuda(x, scale, bias, kind, eps)
    fwd = lambda: NK.norm_fwd_cuda(x, scale, bias, kind, eps)          # noqa: E731
    bwd = lambda: NK.norm_bwd_cuda(dy, x, scale, mean, rstd, kind)     # noqa: E731
    g1, g2 = bwd(), bwd()
    repeat_equal = all(a is None or torch.equal(a, b) for a, b in zip(g1, g2))

    def autograd_ms(make):
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, scale, bias)
                  if t is not None]
        out = make(*leaves)
        return events_ms(torch, lambda: torch.autograd.grad(out, leaves, dy,
                                                            retain_graph=True), iters)

    def chain(a, s, b=None):
        return ref.norm_ref(a, s, b, kind, eps)

    def library(a, s, b=None):
        # PyTorch's fused norms take the weights in x's dtype on the card.
        s, b = s.to(a.dtype), None if b is None else b.to(a.dtype)
        if kind == "layernorm":
            return F.layer_norm(a, (C,), s, b, eps)
        return F.rms_norm(a, (C,), s, eps)

    fbytes = acc.nbytes(x, scale, bias, y, mean, rstd)
    bbytes = acc.nbytes(x, dy, scale, mean, rstd, *g1)
    with torch.no_grad():
        out = dict(what=n["what"], shape=list(x.shape), kind=kind,
                   dtype=str(dtype).removeprefix("torch."),
                   fwd_calls=n["fwd"], bwd_calls=n["bwd"], prefill_calls=n["prefill"],
                   fwd_bound_ms=fbytes / HBM_BYTES_PER_S * 1e3,
                   bwd_bound_ms=bbytes / HBM_BYTES_PER_S * 1e3,
                   fwd_ms=events_ms(torch, fwd, iters), fwd_device_ms=device_ms(torch, fwd),
                   bwd_ms=events_ms(torch, bwd, iters), bwd_device_ms=device_ms(torch, bwd),
                   plain_fwd_ms=events_ms(torch, lambda: chain(x, scale, bias), iters),
                   plain_fwd_device_ms=device_ms(torch, lambda: chain(x, scale, bias)),
                   library_fwd_ms=events_ms(torch, lambda: library(x, scale, bias), iters),
                   bwd_repeat_bit_equal=repeat_equal)
    out["plain_bwd_ms"] = autograd_ms(chain)
    out["library_bwd_ms"] = autograd_ms(library)
    out["fwd_roofline_pct"] = 100 * out["fwd_bound_ms"] / out["fwd_device_ms"]
    out["bwd_roofline_pct"] = 100 * out["bwd_bound_ms"] / out["bwd_device_ms"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_norm: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chipbench import weights as W
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    cells, ok = [], True
    for cell in args.cells:
        config, B, lengths, train = CELLS[cell]
        m = json.loads((ROOT / "chipbench" / "configs" / f"{config}.json").read_text())["model"]
        dtype = W.dtype_of(m["dtype"])
        per_len = []
        for T in lengths:
            shapes = [bench_shape(torch, n, dtype, args.iters) for n in step_norms(m, B, T)]
            for s in shapes:
                ok &= s["bwd_repeat_bit_equal"]
                print(f"{cell} T={T} {s['what']} {s['kind']} {s['dtype']} {s['shape']}: "
                      f"forward {s['fwd_device_ms']:.4f} ms device ({s['fwd_ms']:.4f} "
                      f"events, bound {s['fwd_bound_ms']:.4f}: "
                      f"{s['fwd_roofline_pct']:.1f}%), plain {s['plain_fwd_device_ms']:.4f}"
                      f", library {s['library_fwd_ms']:.4f}; backward "
                      f"{s['bwd_device_ms']:.4f} ms device ({s['bwd_ms']:.4f} events, "
                      f"bound {s['bwd_bound_ms']:.4f}: {s['bwd_roofline_pct']:.1f}%), "
                      f"plain {s['plain_bwd_ms']:.4f}, library {s['library_bwd_ms']:.4f}; "
                      f"second backward bit-equal {s['bwd_repeat_bit_equal']}", flush=True)
            if train:
                step = dict(
                    kernel_ms=sum(s["fwd_calls"] * s["fwd_device_ms"]
                                  + s["bwd_calls"] * s["bwd_device_ms"] for s in shapes),
                    plain_ms=sum(s["fwd_calls"] * s["plain_fwd_device_ms"]
                                 + s["bwd_calls"] * s["plain_bwd_ms"] for s in shapes),
                    bound_ms=sum(s["fwd_calls"] * s["fwd_bound_ms"]
                                 + s["bwd_calls"] * s["bwd_bound_ms"] for s in shapes))
                what = "a train step"
            else:
                step = {f"{k}_ms": sum(s["prefill_calls"] * s[f"{src}_ms"] for s in shapes)
                        for k, src in (("kernel", "fwd_device"), ("plain", "plain_fwd_device"),
                                       ("bound", "fwd_bound"))}
                what = f"a prefill batch of {B} x {T}"
            print(f"{cell}: norms of {what}: kernels {step['kernel_ms']:.3f} ms device, "
                  f"plain chain {step['plain_ms']:.3f} ms, bound {step['bound_ms']:.3f} ms",
                  flush=True)
            per_len.append(dict(T=T, shapes=shapes, **step))
            torch.cuda.empty_cache()
        cells.append(dict(cell=cell, lengths=per_len))
    print(json.dumps({"card": smi.stdout.strip(), "cells": cells,
                      "bwd_repeat_bit_equal": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

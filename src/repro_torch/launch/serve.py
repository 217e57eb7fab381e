"""Batched serving launcher: prefill a random prompt batch, then decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \\
        --layers 8 --batch 4 --prompt-len 1024 --steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
        --layers 8 --batch 4 --prompt-len 1024 --steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \\
        --layers 8 --batch 4 --prompt-len 3000 --steps 32

Runs on the CUDA card unless ``--device cpu`` is given; ``--device cuda``
without a card raises.  Weights are random, drawn from ``--seed`` on the
device; ``--layers`` cuts the depth, every width stays the architecture's.
``--tiny`` selects the architecture's tiny test config in f32, as the
reference launcher does.  Prints prefill ms, decode ms/step and tok/s, with
the clocks read after a device synchronize.  The first prefill in a
process also loads the CUDA kernels it runs, and in a fresh checkout
builds them (``repro_torch.kernels._build``); ``launch.profile_serve``
times warm runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, NamedTuple, Optional

import torch

from repro_torch.configs.registry import ARCHS, get_config, tiny_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.serve.decode import make_prefill, make_serve_step


class ServeRun(NamedTuple):
    cfg: ModelConfig
    tokens: torch.Tensor          # (B, steps) generated tokens
    logits: List[torch.Tensor]    # per step, (B, 1, Vp)
    prefill_ms: float
    decode_ms_per_step: float
    decode_tok_s: float


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resolve_device(name: str) -> torch.device:
    """``--device name`` as a device; ``cuda`` without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available; "
                           "pass --device cpu to run on the CPU")
    return device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen3-32b", choices=sorted(ARCHS))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the architecture's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def setup(args: argparse.Namespace):
    """(model, prompt) for parsed arguments; weights and prompt are drawn
    from ``args.seed`` on ``args.device``."""
    device = resolve_device(args.device)
    cfg = tiny_config(args.arch) if args.tiny else get_config(args.arch)
    if args.tiny:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    if args.layers is not None:
        if not 0 < args.layers <= cfg.n_layers:
            raise ValueError(f"--layers must be in 1..{cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.steps < 1 or args.prompt_len < 1 or args.batch < 1:
        raise ValueError("--batch, --prompt-len and --steps must be >= 1")
    print(f"arch={cfg.name} layers={cfg.n_layers} dtype={cfg.dtype} "
          f"batch={args.batch} prompt={args.prompt_len} decode={args.steps} "
          f"device={device}", flush=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = init_params(cfg, gen, device)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    return model, prompt


@torch.inference_mode()
def serve_batch(model: Transformer, prompt: torch.Tensor,
                steps: int) -> ServeRun:
    """Prefill ``prompt`` and decode ``steps`` greedy tokens, timed."""
    B, Tp = prompt.shape
    prefill = make_prefill(model, Tp + steps)
    step = make_serve_step(model)

    sync(prompt.device)
    t0 = time.perf_counter()
    tok, logits, cache = prefill(prompt)
    sync(prompt.device)
    t_pre = time.perf_counter() - t0
    print(f"prefill: {t_pre * 1e3:.3f} ms ({B * Tp / t_pre:.1f} tok/s)",
          flush=True)

    toks, all_logits = [tok], [logits]
    t1 = time.perf_counter()
    for i in range(steps - 1):
        tok, logits, cache = step(cache, tok[:, None], Tp + i)
        toks.append(tok)
        all_logits.append(logits)
    sync(prompt.device)
    t_dec = time.perf_counter() - t1
    ms_step = t_dec / max(steps - 1, 1) * 1e3
    tok_s = B * (steps - 1) / t_dec if t_dec > 0 else 0.0
    print(f"decode: {ms_step:.3f} ms/step, {tok_s:.1f} tok/s "
          f"({steps - 1} steps)", flush=True)
    out = torch.stack(toks, dim=1)
    print("sample:", out[0, :16].tolist(), flush=True)
    return ServeRun(model.cfg, out, all_logits, t_pre * 1e3, ms_step, tok_s)


def run(argv=None) -> ServeRun:
    args = parse_args(argv)
    model, prompt = setup(args)
    return serve_batch(model, prompt, args.steps)


def main(argv: Optional[list] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

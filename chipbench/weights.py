"""The inputs every cell makes from its seed: weights, token corpus, prompts.

The benchmark makes these itself and hands the same tensors to the program
and to the reference.  Weights are named as the program's state dict names
them (``embed.table``, ``layers.3.mixer.wq``, ...); :func:`param_specs`
works the names and shapes out from a configuration file's ``model``
section alone, so the reference needs nothing of the program to read them.

Weights are drawn on the device from one ``torch.Generator`` in a few large
calls of ``CHUNK`` normals each and cut into leaves in :func:`param_specs`
order, so the same seed gives the same bits on the same card, and a leaf
can be drawn again later (:func:`leaves`) without keeping a copy.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch

CHUNK = 1 << 28          # normals drawn per generator call
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


class Spec(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str            # "dense" N(0,1)/sqrt(fan_in), "scale" 1 + N/10, "shift" N/10
    fan_in: int


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def vocab_padded(m: dict) -> int:
    pad = max(m.get("pad_vocab_to", 512), 1)
    return -(-m["vocab"] // pad) * pad


def head_dim(m: dict) -> int:
    return m.get("d_head") or m["d_model"] // m["n_heads"]


def param_specs(m: dict) -> List[Spec]:
    """Every leaf of a decoder of attention blocks, dense or MoE FFN."""
    D, H, K, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], head_dim(m)
    F, E = m["d_ff"], m.get("moe_experts", 0)
    wd, f32 = dtype_of(m.get("dtype", "bfloat16")), torch.float32
    Vp = vocab_padded(m)

    def norm(prefix: str) -> List[Spec]:
        out = [Spec(prefix + ".scale", (D,), f32, "scale", 1)]
        if m.get("norm", "rmsnorm") == "layernorm":
            out.append(Spec(prefix + ".bias", (D,), f32, "shift", 1))
        return out

    gated = m.get("ffn", "swiglu") in ("swiglu", "geglu")
    specs = [Spec("embed.table", (Vp, D), wd, "dense", D),
             Spec("embed.head", (D, Vp), wd, "dense", D)]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        specs += norm(p + "norm1")
        specs += [Spec(p + "mixer.wq", (D, H, hd), wd, "dense", D),
                  Spec(p + "mixer.wk", (D, K, hd), wd, "dense", D),
                  Spec(p + "mixer.wv", (D, K, hd), wd, "dense", D),
                  Spec(p + "mixer.wo", (H, hd, D), wd, "dense", H * hd)]
        specs += norm(p + "norm2")
        if E:
            specs.append(Spec(p + "ffn.router", (D, E), f32, "dense", D))
            specs += [Spec(p + "ffn.wi", (E, D, F), wd, "dense", D),
                      Spec(p + "ffn.wo", (E, F, D), wd, "dense", F)]
            if gated:
                specs.append(Spec(p + "ffn.wg", (E, D, F), wd, "dense", D))
        else:
            specs += [Spec(p + "ffn.wi", (D, F), wd, "dense", D),
                      Spec(p + "ffn.wo", (F, D), wd, "dense", F)]
            if gated:
                specs.append(Spec(p + "ffn.wg", (D, F), wd, "dense", D))
    specs += norm("final_norm")
    return specs


def _seed(seed: int, stream: int) -> int:
    """A generator seed for one of a run's independent streams."""
    return (seed * 1_000_003 + stream) % (1 << 63)


def leaves(m: dict, seed: int, device) -> Iterator[Tuple[Spec, torch.Tensor]]:
    """(spec, tensor in the spec's dtype) for every leaf, in
    :func:`param_specs` order, drawn from the seed on ``device``."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 1))
    buf = torch.empty(0, device=device)
    for spec in param_specs(m):
        n = math.prod(spec.shape)
        parts, need = [], n
        while need:
            if not buf.numel():
                buf = torch.randn(CHUNK, generator=gen, device=device)
            take = min(need, buf.numel())
            parts.append(buf[:take])
            buf, need = buf[take:], need - take
        z = (parts[0] if len(parts) == 1 else torch.cat(parts)).view(spec.shape)
        if spec.init == "dense":
            w = z * spec.fan_in ** -0.5
        elif spec.init == "scale":
            w = 1 + 0.1 * z
        else:
            w = 0.1 * z
        yield spec, w.to(spec.dtype)


def make_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return {spec.name: w for spec, w in leaves(m, seed, device)}


@torch.no_grad()
def load_into(params: Dict[str, torch.Tensor], m: dict, seed: int) -> None:
    """Fill the program's parameters (its ``named_parameters``) in place;
    the names, shapes and dtypes have to be exactly :func:`param_specs`'."""
    specs = {s.name: s for s in param_specs(m)}
    got = {n: (tuple(p.shape), p.dtype) for n, p in params.items()}
    want = {n: (s.shape, s.dtype) for n, s in specs.items()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()), key=str)[:6]
        raise ValueError(f"the program's parameters differ from the "
                         f"configuration's: {diff}")
    device = next(iter(params.values())).device
    for spec, w in leaves(m, seed, device):
        params[spec.name].copy_(w)


def corpus(seed: int, n: int, seq: int, vocab: int) -> np.ndarray:
    """(n, seq) int32 token samples, uniform in [0, vocab)."""
    rng = np.random.default_rng([seed, 2])
    return rng.integers(0, vocab, size=(n, seq), dtype=np.int32)


def prompt(seed: int, index: int, batch: int, length: int, vocab: int,
           device) -> torch.Tensor:
    """Request batch ``index``'s (batch, length) int64 prompt tokens."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 1000 + index))
    return torch.randint(0, vocab, (batch, length), generator=gen,
                         device=device)

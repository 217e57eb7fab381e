"""The weights of a hybrid Mamba / attention configuration (Jamba), as the
benchmark hands them to the program and to the reference.

Layer ``i`` is ``pattern[i % len(pattern)]`` of the configuration file's
``model``.  Every layer holds ``norm1``, its mixer, ``norm2`` and a dense
SwiGLU FFN (``ffn.wi``, ``ffn.wg``, ``ffn.wo``); an ``attn`` mixer holds
``wq``, ``wk``, ``wv``, ``wo`` as :mod:`chipbench.weights` names them, a
``mamba`` mixer the leaves of the port's ``models.ssm``: ``in_proj``
(D, 2I), ``conv_w`` (W, I), ``conv_b``, ``x_proj`` (I, R + 2N), ``dt_proj``
(R, I), ``dt_bias``, ``A_log`` (I, N), ``D``, ``out_proj`` (I, D) and the
RMSNorm scales ``dt_norm`` (R), ``b_norm``, ``c_norm`` (N).  Names, shapes
and dtypes come from the configuration alone (:func:`param_specs`).

Drawn as Mamba's published initialisation draws them, so that the scan
carries state across hundreds of positions as a trained model's does:

* matrices N(0,1)/sqrt(fan_in) (``dense``);
* ``A_log`` log(1..N) along the state, the same for every channel (drawn
  from nothing);
* ``dt_bias`` the inverse softplus of a step drawn log-uniform in
  [0.001, 0.1];
* ``conv_b`` uniform in +-1/sqrt(d_conv), ``torch.nn.Conv1d``'s default,
  which the published mixer keeps;
* ``D`` and every norm scale 1 + N/10 (``scale``).

The draws come from one generator in :mod:`chipbench.weights`' order and
chunks (a uniform is a normal through its distribution function), so the
same seed gives the same bits on the same card and a leaf can be drawn
again (:func:`leaves`).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

from chipbench.weights import (CHUNK, Spec, _seed, corpus, dtype_of,  # noqa: F401
                               head_dim, prompt, vocab_padded)

DT_MIN, DT_MAX = 1e-3, 1e-1


def layer_kind(m: dict, i: int) -> str:
    return m["pattern"][i % len(m["pattern"])]


def param_specs(m: dict) -> List[Spec]:
    D, H, K, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], head_dim(m)
    F, I, R, N, W = m["d_ff"], m["d_inner"], m["dt_rank"], m["ssm_state"], m["ssm_conv"]
    wd, f32 = dtype_of(m.get("dtype", "bfloat16")), torch.float32
    Vp = vocab_padded(m)
    specs = [Spec("embed.table", (Vp, D), wd, "dense", D),
             Spec("embed.head", (D, Vp), wd, "dense", D)]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        specs.append(Spec(p + "norm1.scale", (D,), f32, "scale", 1))
        if layer_kind(m, i) == "attn":
            specs += [Spec(p + "mixer.wq", (D, H, hd), wd, "dense", D),
                      Spec(p + "mixer.wk", (D, K, hd), wd, "dense", D),
                      Spec(p + "mixer.wv", (D, K, hd), wd, "dense", D),
                      Spec(p + "mixer.wo", (H, hd, D), wd, "dense", H * hd)]
        else:
            q = p + "mixer."
            specs += [Spec(q + "in_proj", (D, 2 * I), wd, "dense", D),
                      Spec(q + "conv_w", (W, I), wd, "dense", W),
                      Spec(q + "conv_b", (I,), f32, "uniform", W),
                      Spec(q + "x_proj", (I, R + 2 * N), wd, "dense", I),
                      Spec(q + "dt_proj", (R, I), wd, "dense", R),
                      Spec(q + "dt_bias", (I,), f32, "dt_bias", 1),
                      Spec(q + "A_log", (I, N), f32, "a_log", 1),
                      Spec(q + "D", (I,), f32, "scale", 1),
                      Spec(q + "out_proj", (I, D), wd, "dense", I),
                      Spec(q + "dt_norm", (R,), f32, "scale", 1),
                      Spec(q + "b_norm", (N,), f32, "scale", 1),
                      Spec(q + "c_norm", (N,), f32, "scale", 1)]
        specs += [Spec(p + "norm2.scale", (D,), f32, "scale", 1),
                  Spec(p + "ffn.wi", (D, F), wd, "dense", D),
                  Spec(p + "ffn.wo", (F, D), wd, "dense", F),
                  Spec(p + "ffn.wg", (D, F), wd, "dense", D)]
    specs.append(Spec("final_norm.scale", (D,), f32, "scale", 1))
    return specs


def _uniform(z: torch.Tensor) -> torch.Tensor:
    """A normal draw through its distribution function: uniform in (0, 1)."""
    return 0.5 * (1 + torch.erf(z * 2 ** -0.5))


def _value(spec: Spec, z: torch.Tensor) -> torch.Tensor:
    if spec.init == "dense":
        return z * spec.fan_in ** -0.5
    if spec.init == "scale":
        return 1 + 0.1 * z
    if spec.init == "uniform":
        return (2 * _uniform(z) - 1) * spec.fan_in ** -0.5
    if spec.init == "dt_bias":
        dt = torch.exp(math.log(DT_MIN) + _uniform(z) * (math.log(DT_MAX) - math.log(DT_MIN)))
        return dt + torch.log(-torch.expm1(-dt))          # softplus(b) = dt
    raise ValueError(f"unknown init {spec.init!r}")


def leaves(m: dict, seed: int, device) -> Iterator[Tuple[Spec, torch.Tensor]]:
    """(spec, tensor in the spec's dtype) for every leaf, in
    :func:`param_specs` order, drawn from the seed on ``device``."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 1))
    buf = torch.empty(0, device=device)
    for spec in param_specs(m):
        if spec.init == "a_log":
            n = torch.arange(1, spec.shape[1] + 1, dtype=torch.float32, device=device)
            yield spec, torch.log(n).expand(spec.shape).contiguous()
            continue
        parts, need = [], math.prod(spec.shape)
        while need:
            if not buf.numel():
                buf = torch.randn(CHUNK, generator=gen, device=device)
            take = min(need, buf.numel())
            parts.append(buf[:take])
            buf, need = buf[take:], need - take
        z = (parts[0] if len(parts) == 1 else torch.cat(parts)).view(spec.shape)
        yield spec, _value(spec, z).to(spec.dtype)


def make_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return {spec.name: w for spec, w in leaves(m, seed, device)}


@torch.no_grad()
def load_into(params: Dict[str, torch.Tensor], m: dict, seed: int) -> None:
    """Fill the program's parameters (its ``named_parameters``) in place;
    the names, shapes and dtypes have to be exactly :func:`param_specs`'."""
    got = {n: (tuple(p.shape), p.dtype) for n, p in params.items()}
    want = {s.name: (s.shape, s.dtype) for s in param_specs(m)}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()), key=str)[:6]
        raise ValueError(f"the program's parameters differ from the "
                         f"configuration's: {diff}")
    device = next(iter(params.values())).device
    for spec, w in leaves(m, seed, device):
        params[spec.name].copy_(w)

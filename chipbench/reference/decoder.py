"""Plain float32 reference of the decoder configurations.

A decoder of pre-norm blocks: layernorm or rmsnorm; attention with RoPE
(the rotation of the two halves of each head), grouped KV heads and a
causal mask; an FFN that is gelu (tanh form) or swiglu, or a mixture of
swiglu experts behind a top-k router with a capacity; an untied output
head over a vocabulary padded to a multiple, the padded slots masked.
Training takes the mean next-token cross entropy plus 0.01 times the
routers' load-balance loss, and AdamW with global-norm clipping and
decoupled weight decay on the matrices.

Everything is computed in float32 with TF32 off.  The weights are stored
as the configuration states them (bf16 matrices, f32 norms and router), so
an update is computed in f32 and stored rounded to that dtype, as a
deployment's weights are.  With ``fp8=True`` every matrix product takes
its operands rounded to float8 (e4m3 forward, e5m2 for gradients, one
scale per tensor): the control, computed one precision below the
configuration's bf16.

Nothing here comes from the program: the weights are given by name (the
state-dict names of :mod:`chipbench.weights`), and memory is kept in
bounds the plain way, by running the layers one at a time, recomputing
each in the backward from its saved input, and attention one sequence and
one KV group at a time.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def strict_f32() -> None:
    """Matrix products in true float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- precision ---------------------------------------------------------------
def _round8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if not x.numel():       # an expert that no token reached
        return x
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


def _ops(fp8: bool) -> Callable:
    if not fp8:
        return torch.einsum
    return lambda eq, a, b: torch.einsum(eq, _Fp8.apply(a), _Fp8.apply(b))


# -- blocks ------------------------------------------------------------------
def _getter(weights: Weights):
    """``w(name)`` gives a stored leaf in f32, ``w(name, e)`` expert e's
    slice of it."""
    return lambda n, e=None: (weights[n] if e is None else weights[n][e]).float()


class Model:
    """The configuration's arithmetic.  ``w(name, e=None)`` gives a leaf
    (or expert e's slice of it) in f32."""

    def __init__(self, m: dict, eps: float, fp8: bool = False):
        self.m, self.eps, self.mm = m, eps, _ops(fp8)
        self.D, self.H, self.K = m["d_model"], m["n_heads"], m["n_kv_heads"]
        self.hd = m.get("d_head") or self.D // self.H
        self.E, self.k = m.get("moe_experts", 0), m.get("moe_topk", 0)
        self.V = m["vocab"]
        self.layernorm = m.get("norm", "rmsnorm") == "layernorm"
        self.ffn = m.get("ffn", "swiglu")
        self.theta = m.get("rope_theta", 10000.0)

    def norm(self, w, prefix: str, x: torch.Tensor) -> torch.Tensor:
        if self.layernorm:
            mu = x.mean(-1, keepdim=True)
            var = ((x - mu) ** 2).mean(-1, keepdim=True)
            return ((x - mu) * torch.rsqrt(var + self.eps) * w(prefix + ".scale")
                    + w(prefix + ".bias"))
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * w(prefix + ".scale")

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        T, half = x.shape[1], x.shape[-1] // 2
        inv = self.theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        a, b = x[..., :half], x[..., half:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)

    def qkv(self, w, p: str, x: torch.Tensor):
        h = self.norm(w, p + "norm1", x)
        q = self.rope(self.mm("btd,dhk->bthk", h, w(p + "mixer.wq")))
        k = self.rope(self.mm("btd,dhk->bthk", h, w(p + "mixer.wk")))
        v = self.mm("btd,dhk->bthk", h, w(p + "mixer.wv"))
        return q, k, v

    def attend(self, q, k, v) -> torch.Tensor:
        """Causal softmax attention, one sequence and one KV group at a
        time: query head h reads KV head h // (H / K)."""
        B, T, H, hd = q.shape
        r = H // self.K
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        out = []
        for b in range(B):
            heads = []
            for g in range(self.K):
                s = self.mm("thd,sd->hts", q[b, :, g * r:(g + 1) * r], k[b, :, g]) * hd ** -0.5
                s = s.masked_fill(~mask, float("-inf"))
                heads.append(self.mm("hts,sd->thd", torch.softmax(s, dim=-1), v[b, :, g]))
            out.append(torch.cat(heads, dim=1))
        return torch.stack(out)

    def attn(self, w, p: str, x: torch.Tensor, on_kv=None) -> torch.Tensor:
        q, k, v = self.qkv(w, p, x)
        if on_kv is not None:
            on_kv(k, v)
        return self.mm("bthk,hkd->btd", self.attend(q, k, v), w(p + "mixer.wo"))

    def dense_ffn(self, w, p: str, h: torch.Tensor) -> torch.Tensor:
        u = self.mm("btd,df->btf", h, w(p + "ffn.wi"))
        if self.ffn == "gelu":
            a = F.gelu(u, approximate="tanh")
        else:
            g = self.mm("btd,df->btf", h, w(p + "ffn.wg"))
            a = (F.silu(g) if self.ffn == "swiglu" else F.gelu(g, approximate="tanh")) * u
        return self.mm("btf,fd->btd", a, w(p + "ffn.wo"))

    def capacity(self, n_tokens: int) -> int:
        c = int(self.m.get("moe_capacity", 1.25) * self.k * n_tokens / self.E)
        return max(8, -(-c // 8) * 8)

    def moe(self, w, p: str, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k routing over f32 router logits, the k weights a softmax
        over their logits; the slots (token s, choice j) of each expert
        take its capacity in the order s*k + j, and slots past it are
        dropped.  Returns (output, load-balance loss)."""
        B, T, D = h.shape
        x = h.reshape(B * T, D)
        N, E, k = B * T, self.E, self.k
        logits = x @ w(p + "ffn.router")
        probs = torch.softmax(logits, dim=-1)
        top, choice = torch.topk(logits, k, dim=-1)
        gate = torch.softmax(top, dim=-1).reshape(-1)
        flat = choice.reshape(-1)
        counts = torch.bincount(flat, minlength=E)
        # Position of each slot among its expert's slots, in slot order.
        onehot = F.one_hot(flat, E)
        pos = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
        keep = pos < self.capacity(N)
        y = torch.zeros_like(x)
        for e in range(E):
            slots = torch.nonzero((flat == e) & keep)[:, 0]
            tok = slots // k
            xe = x[tok]
            u = self.mm("nd,df->nf", xe, w(p + "ffn.wi", e))
            g = self.mm("nd,df->nf", xe, w(p + "ffn.wg", e))
            a = self.mm("nf,fd->nd", F.silu(g) * u, w(p + "ffn.wo", e))
            y = y.index_add(0, tok, a * gate[slots, None])
        aux = E * torch.sum(probs.mean(0) * counts.float() / counts.sum().clamp(min=1))
        return y.reshape(B, T, D), aux

    def ffn_part(self, w, p: str, x: torch.Tensor):
        h = self.norm(w, p + "norm2", x)
        if self.E:
            return self.moe(w, p, h)
        return self.dense_ffn(w, p, h), None

    def layer(self, w, i: int, x: torch.Tensor, on_kv=None):
        p = f"layers.{i}."
        x = x + self.attn(w, p, x, on_kv)
        y, aux = self.ffn_part(w, p, x)
        return x + y, aux

    def logits(self, w, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(w, "final_norm", x)
        z = self.mm("btd,dv->btv", h, w("embed.head"))
        if z.shape[-1] > self.V:
            z = z.masked_fill(torch.arange(z.shape[-1], device=z.device) >= self.V, -1e30)
        return z


# -- serving -----------------------------------------------------------------
@torch.no_grad()
def prefill(m: dict, eps: float, weights: Weights, tokens: torch.Tensor,
            on_kv: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]] = None,
            fp8: bool = False) -> torch.Tensor:
    """Last-position logits (B, Vp) of ``tokens`` (B, T); ``on_kv(layer,
    k, v)`` sees each layer's keys (after RoPE) and values (B, T, K, hd)."""
    strict_f32()
    model = Model(m, eps, fp8)
    w = _getter(weights)
    x = weights["embed.table"][tokens].float() * math.sqrt(model.D)
    for i in range(m["n_layers"]):
        hook = None if on_kv is None else (lambda k, v, i=i: on_kv(i, k, v))
        x, _ = model.layer(w, i, x, hook)
    return model.logits(w, x[:, -1:])[:, 0]


# -- training ----------------------------------------------------------------
class _Leaves:
    """f32 copies of stored leaves that collect gradients, added into
    ``grads`` (whole leaves, or one expert's slice) by :meth:`flush`."""

    def __init__(self, weights: Weights):
        self.weights, self.made = weights, {}

    def __call__(self, name: str, e: Optional[int] = None) -> torch.Tensor:
        key = (name, e)
        if key not in self.made:
            src = self.weights[name] if e is None else self.weights[name][e]
            self.made[key] = src.to(torch.float32, copy=True).requires_grad_(True)
        return self.made[key]

    def flush(self, grads: Weights) -> None:
        for (name, e), t in self.made.items():
            if t.grad is not None:
                (grads[name] if e is None else grads[name][e]).add_(t.grad)
        self.made.clear()


def loss_and_grads(model: Model, weights: Weights, tokens: torch.Tensor,
                   grads: Weights, aux_weight: float = 0.01) -> float:
    """The loss of one batch; its gradients are added into ``grads``."""
    m = model.m
    labels = torch.roll(tokens, -1, dims=1)
    w = _getter(weights)
    with torch.no_grad():
        x = weights["embed.table"][tokens].float() * math.sqrt(model.D)
        saved, aux_total = [], 0.0
        for i in range(m["n_layers"]):
            saved.append(x)
            x, aux = model.layer(w, i, x)
            if aux is not None:
                aux_total += float(aux)
    leaves = _Leaves(weights)
    xl = x.requires_grad_(True)
    with torch.enable_grad():
        z = model.logits(leaves, xl)
        ce = F.cross_entropy(z.reshape(-1, z.shape[-1]), labels.reshape(-1))
        ce.backward()
    leaves.flush(grads)
    g, ce = xl.grad, float(ce.detach())
    del z, xl
    for i in reversed(range(m["n_layers"])):
        g = _layer_backward(model, weights, leaves, grads, i, saved.pop(), g, aux_weight)
    grads["embed.table"].index_add_(0, tokens.reshape(-1),
                                    g.reshape(-1, model.D) * math.sqrt(model.D))
    return ce + aux_weight * aux_total


def _layer_backward(model: Model, weights: Weights, leaves: _Leaves,
                    grads: Weights, i: int, x: torch.Tensor, g: torch.Tensor,
                    aux_weight: float) -> torch.Tensor:
    """Recompute layer i from its input and run its backward: the FFN over
    the whole batch, attention one sequence at a time."""
    p = f"layers.{i}."
    with torch.no_grad():
        h1 = x + model.attn(_getter(weights), p, x)
    h1 = h1.requires_grad_(True)
    with torch.enable_grad():
        y, aux = model.ffn_part(leaves, p, h1)
        outs, gouts = [y], [g]
        if aux is not None:
            outs.append(aux)
            gouts.append(torch.full_like(aux, aux_weight))
        torch.autograd.backward(outs, gouts)
    gh = g + h1.grad
    del y, aux, h1
    gx = gh.clone()
    for b in range(x.shape[0]):
        xb = x[b:b + 1].clone().requires_grad_(True)
        with torch.enable_grad():
            model.attn(leaves, p, xb).backward(gh[b:b + 1])
        gx[b] += xb.grad[0]
    leaves.flush(grads)
    return gx


class AdamW:
    """AdamW on stored weights: f32 moments, global-norm clipping, bias
    correction, decoupled weight decay on leaves of two or more dims, the
    result stored back in each leaf's dtype."""

    def __init__(self, weights: Weights, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip, self.t = weight_decay, grad_clip, 0
        self.m = {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                  for n, t in weights.items()}
        self.v = {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                  for n, t in weights.items()}

    @torch.no_grad()
    def step(self, weights: Weights, grads: Weights) -> Tuple[float, Dict[str, float]]:
        """Update ``weights`` in place; returns (global norm, each leaf's
        clipped gradient norm, the gradient as the optimizer takes it)."""
        self.t += 1
        gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
        c = min(1.0, self.clip / max(gnorm, 1e-12))
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        seen = {}
        for n, p in weights.items():
            g = grads[n] * c
            seen[n] = float(torch.linalg.vector_norm(g))
            m, v = self.m[n], self.v[n]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            pf = p.float()
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if p.ndim >= 2:
                delta = delta + self.wd * pf
            p.copy_(pf - self.lr * delta)
        return gnorm, seen


def train(m: dict, eps: float, weights: Weights, batches: List[torch.Tensor],
          opt: dict, fp8: bool = False) -> dict:
    """Train ``weights`` (updated in place) on ``batches``: the loss of
    each step, each leaf's gradient norm at step 1 as computed and as the
    optimizer takes it (clipped), and the global norms."""
    strict_f32()
    model = Model(m, eps, fp8)
    adam = AdamW(weights, **opt)
    out = {"loss": [], "grad_norm": [], "grad1": None, "grad1_raw": None}
    for t, tokens in enumerate(batches):
        grads = {n: torch.zeros(w.shape, dtype=torch.float32, device=w.device)
                 for n, w in weights.items()}
        out["loss"].append(loss_and_grads(model, weights, tokens, grads))
        if t == 0:
            out["grad1_raw"] = {n: float(torch.linalg.vector_norm(g))
                                for n, g in grads.items()}
        gnorm, seen = adam.step(weights, grads)
        out["grad_norm"].append(gnorm)
        if t == 0:
            out["grad1"] = seen
        del grads
    return out

"""Plain float32 reference of the hybrid Mamba / attention configuration
(AI21's Jamba, ``modeling_jamba``).

Layer ``i`` is ``pattern[i % len(pattern)]``; every layer is
``x += mixer(rmsnorm1(x))`` then ``x += swiglu(rmsnorm2(x))``.

* ``attn``: causal grouped-KV attention (query head h reads KV head
  h // (H / K)) with no positional encoding (Jamba's has none), a few query
  heads at a time.
* ``mamba``: ``[u, z] = h W_in``; ``u' = silu(causal depthwise conv(u) +
  b_conv)``; ``[dt, B, C] = u' W_x`` of widths R, N and N, each through an
  RMSNorm of its own width with a learned scale; ``delta = softplus(dt
  W_dt + b_dt)``, ``A = -exp(A_log)``; the selective scan ``h_t =
  exp(delta_t A) h_{t-1} + delta_t B_t u'_t``, ``y_t = C_t . h_t + D u'_t``;
  ``out = (y * silu(z)) W_out``.
* the FFN: ``(silu(h W_g) * h W_i) W_o``;
* a final RMSNorm and an untied head over a vocabulary padded to a
  multiple, the padded slots masked.

The scan (:func:`scan`) is computed in chunks of ``CHUNK`` steps, every
chunk at once: inside a chunk the recurrence runs from a zero state, one
step of all chunks at a time, each step's decay the exp of the difference
of consecutive cumulative sums of ``delta * A``, ``exp(delta_t A)``; across
chunks the state is carried over the chunks' ends, and what the state
entering a chunk adds to its steps decays by the exp of the cumulative sum
from the chunk's start.  Every decay is the exp of a sum of ``delta * A``,
never a ratio of two exps.  So a sequence of 8192 steps is two loops, of
``CHUNK`` and of 8192 / ``CHUNK``; ``CHANNELS`` channels are taken at a time
and recomputed in the backward (``torch.utils.checkpoint``), so the
sequence fits beside the model.  :func:`scan_sequential` is the recurrence
step by step, which the tests hold the chunked form to.

Training is what :mod:`chipbench.reference.decoder` does for the attention
models, written out again here so that the module imports nothing but
torch: the mean next-token cross entropy, AdamW with global-norm clipping,
bias correction and decoupled weight decay on the matrices, in float32 with
TF32 off, the update stored back in each leaf's configured dtype; layers
run one at a time and each is recomputed in the backward from its saved
input, its mixer one sequence at a time.  ``fp8=True`` rounds every matrix
product's operands to float8 (e4m3 forward, e5m2 for gradients, one scale
per tensor), the control one precision below the configuration's bf16.
Nothing here comes from the program: weights are given by name
(:mod:`chipbench.weights_hybrid`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Weights = Dict[str, torch.Tensor]

CHUNK = 64           # steps a chunk: the loop inside runs CHUNK steps, the carry T / CHUNK
CHANNELS = 2560      # channels whose chunks are held (and recomputed) at once
HEADS = 5            # query heads whose scores are held at once


def strict_f32() -> None:
    """Matrix products in true float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- precision -------------------------------------------------------------------
def _round8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
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


def _getter(weights: Weights):
    """``w(name)`` gives a stored leaf in f32."""
    return lambda n: weights[n].float()


# -- the selective scan --------------------------------------------------------
def scan_sequential(u, delta, A, B, C):
    """The recurrence one step at a time, all in f32: u, delta (Bt,T,I),
    A (I,N), B, C (Bt,T,N); returns y (Bt,T,I) without the D term."""
    Bt, T, I = u.shape
    h = u.new_zeros(Bt, I, A.shape[1])
    ys = []
    for t in range(T):
        h = torch.exp(delta[:, t, :, None] * A) * h + (
            delta[:, t, :, None] * u[:, t, :, None] * B[:, t, None, :])
        ys.append(torch.einsum("bin,bn->bi", h, C[:, t]))
    return torch.stack(ys, 1)


def _chunks(t: torch.Tensor, L: int) -> torch.Tensor:
    """(Bt, T, ...) zero-padded to a multiple of L steps, as (Bt, K, L, ...);
    a padded step has delta 0, so it keeps the state and adds nothing."""
    pad = -t.shape[1] % L
    if pad:
        t = F.pad(t, (0,) * (2 * (t.dim() - 2)) + (0, pad))
    return t.reshape(t.shape[0], -1, L, *t.shape[2:])


def _block(u, delta, A, B, C):
    """One block of channels in chunks: u, delta (Bt,K,L,c); A (c,N);
    B, C (Bt,K,L,N).  Returns y (Bt,K,L,c)."""
    Bt, K, L, c = u.shape
    dA = delta[..., None] * A                                      # (Bt,K,L,c,N)
    step_decay = torch.exp(dA)                                     # exp(S_l - S_(l-1))
    v = (delta * u)[..., None] * B[:, :, :, None, :]
    # Inside every chunk at once, from a zero state, one step at a time.
    h = torch.zeros(Bt, K, c, A.shape[1], dtype=u.dtype, device=u.device)
    hs = []
    for step in range(L):
        h = step_decay[:, :, step] * h + v[:, :, step]
        hs.append(h)
    # Across chunks: the state entering chunk k, carried from the ends.
    S = torch.cumsum(dA, dim=2)                                    # from each chunk's start
    decay, H, entering = torch.exp(S[:, :, -1]), torch.zeros_like(h[:, 0]), []
    for k in range(K):
        entering.append(H)
        H = decay[:, k] * H + h[:, k]
    # Each step's state: its chunk's own part and the entering state's,
    # decayed by exp(S_l - S_start).
    h = torch.stack(hs, 2) + torch.exp(S) * torch.stack(entering, 1)[:, :, None]
    return (h * C[:, :, :, None, :]).sum(-1)


def scan(u, delta, A, B, C, L: int = CHUNK, channels: int = CHANNELS):
    """:func:`scan_sequential`'s result in chunks of L steps, ``channels``
    channels at a time, each block recomputed in the backward."""
    Bt, T, I = u.shape
    uc, dc, Bc, Cc = (_chunks(t, L) for t in (u, delta, B, C))
    y = torch.cat([checkpoint(_block, uc[..., c0:c0 + channels], dc[..., c0:c0 + channels],
                              A[c0:c0 + channels], Bc, Cc, use_reentrant=False)
                   for c0 in range(0, I, channels)], dim=-1)
    return y.reshape(Bt, -1, I)[:, :T]


# -- the model -----------------------------------------------------------------
class Jamba:
    """The configuration's arithmetic.  ``w(name)`` gives a leaf in f32."""

    def __init__(self, m: dict, eps: float, fp8: bool = False):
        self.m, self.eps, self.mm = m, eps, _ops(fp8)
        self.D, self.H, self.K = m["d_model"], m["n_heads"], m["n_kv_heads"]
        self.hd = m.get("d_head") or self.D // self.H
        self.V, self.pattern = m["vocab"], m["pattern"]

    def kind(self, i: int) -> str:
        return self.pattern[i % len(self.pattern)]

    def rmsnorm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * scale

    def attend(self, q, k, v) -> torch.Tensor:
        """Causal softmax attention (query head h reads KV head h // (H / K)),
        one sequence and ``HEADS`` query heads at a time."""
        B, T, H, hd = q.shape
        r = H // self.K
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        out = []
        for b in range(B):
            heads = []
            for g, h0 in ((g, h0) for g in range(self.K)
                          for h0 in range(g * r, (g + 1) * r, HEADS)):
                h1 = min(h0 + HEADS, (g + 1) * r)
                s = self.mm("thd,sd->hts", q[b, :, h0:h1], k[b, :, g]) * hd ** -0.5
                s = s.masked_fill(~mask, float("-inf"))
                heads.append(self.mm("hts,sd->thd", torch.softmax(s, dim=-1), v[b, :, g]))
            out.append(torch.cat(heads, dim=1))
        return torch.stack(out)

    def attn(self, w, p: str, x: torch.Tensor) -> torch.Tensor:
        h = self.rmsnorm(x, w(p + "norm1.scale"))
        q, k, v = (self.mm("btd,dhk->bthk", h, w(p + "mixer." + n)) for n in ("wq", "wk", "wv"))
        return self.mm("bthk,hkd->btd", self.attend(q, k, v), w(p + "mixer.wo"))

    def ffn(self, w, p: str, x: torch.Tensor) -> torch.Tensor:
        h = self.rmsnorm(x, w(p + "norm2.scale"))
        u = self.mm("btd,df->btf", h, w(p + "ffn.wi"))
        g = self.mm("btd,df->btf", h, w(p + "ffn.wg"))
        return self.mm("btf,fd->btd", F.silu(g) * u, w(p + "ffn.wo"))

    def logits(self, w, x: torch.Tensor) -> torch.Tensor:
        z = self.mm("btd,dv->btv", self.rmsnorm(x, w("final_norm.scale")), w("embed.head"))
        if z.shape[-1] > self.V:
            z = z.masked_fill(torch.arange(z.shape[-1], device=z.device) >= self.V, -1e30)
        return z

    def mamba(self, w, p: str, x: torch.Tensor) -> torch.Tensor:
        """The mixer, one sequence at a time."""
        if x.shape[0] > 1:
            return torch.cat([self.mamba(w, p, x[b:b + 1]) for b in range(x.shape[0])])
        m, q = self.m, p + "mixer."
        R, N = m["dt_rank"], m["ssm_state"]
        h = self.rmsnorm(x, w(p + "norm1.scale"))
        u, z = self.mm("btd,de->bte", h, w(q + "in_proj")).chunk(2, dim=-1)
        cw, T = w(q + "conv_w"), u.shape[1]
        up = F.pad(u, (0, 0, cw.shape[0] - 1, 0))
        u = F.silu(sum(up[:, j:j + T] * cw[j] for j in range(cw.shape[0])) + w(q + "conv_b"))
        dt, B, C = self.mm("bti,ie->bte", u, w(q + "x_proj")).split([R, N, N], dim=-1)
        dt, B, C = (self.rmsnorm(t, w(q + n)) for t, n in
                    ((dt, "dt_norm"), (B, "b_norm"), (C, "c_norm")))
        delta = F.softplus(self.mm("btr,ri->bti", dt, w(q + "dt_proj")) + w(q + "dt_bias"))
        y = scan(u, delta, -torch.exp(w(q + "A_log")), B, C) + w(q + "D") * u
        return self.mm("bti,id->btd", y * F.silu(z), w(q + "out_proj"))

    def mixer(self, w, i: int, x: torch.Tensor) -> torch.Tensor:
        p = f"layers.{i}."
        return self.attn(w, p, x) if self.kind(i) == "attn" else self.mamba(w, p, x)

    def layer(self, w, i: int, x: torch.Tensor) -> torch.Tensor:
        x = x + self.mixer(w, i, x)
        return x + self.ffn(w, f"layers.{i}.", x)


@torch.no_grad()
def forward(m: dict, eps: float, weights: Weights, tokens: torch.Tensor,
            fp8: bool = False) -> torch.Tensor:
    """Logits (B, T, Vp) at every position of ``tokens`` (B, T)."""
    strict_f32()
    model = Jamba(m, eps, fp8)
    w = _getter(weights)
    x = weights["embed.table"][tokens].float() * math.sqrt(model.D)
    for i in range(m["n_layers"]):
        x = model.layer(w, i, x)
    return model.logits(w, x)


# -- training ------------------------------------------------------------------
class _Leaves:
    """f32 copies of stored leaves that collect gradients, added into
    ``grads`` by :meth:`flush`."""

    def __init__(self, weights: Weights):
        self.weights, self.made = weights, {}

    def __call__(self, name: str) -> torch.Tensor:
        if name not in self.made:
            self.made[name] = self.weights[name].to(torch.float32, copy=True).requires_grad_(True)
        return self.made[name]

    def flush(self, grads: Weights) -> None:
        for name, t in self.made.items():
            if t.grad is not None:
                grads[name].add_(t.grad)
        self.made.clear()


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


def loss_and_grads(model: Jamba, weights: Weights, tokens: torch.Tensor,
                   grads: Weights) -> float:
    """The loss of one batch; its gradients are added into ``grads``."""
    labels = torch.roll(tokens, -1, dims=1)
    w = _getter(weights)
    with torch.no_grad():
        x = weights["embed.table"][tokens].float() * math.sqrt(model.D)
        saved = []
        for i in range(model.m["n_layers"]):
            saved.append(x)
            x = model.layer(w, i, x)
    leaves = _Leaves(weights)
    xl = x.requires_grad_(True)
    with torch.enable_grad():
        z = model.logits(leaves, xl)
        ce = F.cross_entropy(z.reshape(-1, z.shape[-1]), labels.reshape(-1))
        ce.backward()
    leaves.flush(grads)
    g, ce = xl.grad, float(ce.detach())
    del z, xl
    for i in reversed(range(model.m["n_layers"])):
        g = _layer_backward(model, weights, leaves, grads, i, saved.pop(), g)
    grads["embed.table"].index_add_(0, tokens.reshape(-1),
                                    g.reshape(-1, model.D) * math.sqrt(model.D))
    return ce


def _layer_backward(model: Jamba, weights: Weights, leaves: _Leaves,
                    grads: Weights, i: int, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Recompute layer i from its input and run its backward: the FFN over
    the whole batch, the mixer one sequence at a time."""
    p = f"layers.{i}."
    with torch.no_grad():
        h1 = x + model.mixer(_getter(weights), i, x)
    h1 = h1.requires_grad_(True)
    with torch.enable_grad():
        y = model.ffn(leaves, p, h1)
        y.backward(g)
    gh = g + h1.grad
    del y, h1
    gx = gh.clone()
    for b in range(x.shape[0]):
        xb = x[b:b + 1].clone().requires_grad_(True)
        with torch.enable_grad():
            model.mixer(leaves, i, xb).backward(gh[b:b + 1])
        gx[b] += xb.grad[0]
    leaves.flush(grads)
    return gx


def train(m: dict, eps: float, weights: Weights, batches: List[torch.Tensor],
          opt: dict, fp8: bool = False) -> dict:
    """Train ``weights`` (updated in place) on ``batches``: each step's
    loss, each leaf's gradient norm at step 1 as computed and as the
    optimizer takes it (clipped), and the global norms."""
    strict_f32()
    model = Jamba(m, eps, fp8)
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

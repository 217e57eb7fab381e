"""AdamW with global-norm clipping and a state-dtype policy.

Ported from ``repro.train.optimizer``.  Parameters, gradients and moments
are mappings from the port's parameter names (``Transformer``'s
``named_parameters``) to tensors.  Unlike the reference's pure functions,
:func:`adamw_update` writes the new parameters and moments in place, which
saves a copy of the model and of both moments on the card.
``opt_state_specs`` (sharding) waits for the distribution slice.

Weight decay is decoupled and applied to leaves with ``ndim >= 2``, the
reference's "matrices only".  The port's leaves are per layer, so its norm
scales and biases are 1-d and never decayed.  The reference stacks each
block's leaves along ``n_super``, which makes those vectors 2-d there, so it
decays them in ``blocks`` (but not in ``rem{i}`` or ``final_norm``); the port
does not copy that (ROADMAP.md §4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import torch

Tree = Mapping[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32   # bf16 for llama3-405b (memory budget)


# Elements of a leaf that adamw_update updates at once.
SLICE = 1 << 26


def adamw_init(params: Tree, opt: AdamWConfig) -> Dict[str, Any]:
    """Zero moments in ``opt.state_dtype`` and a step count of 0 (int32),
    on the parameters' device."""
    device = next(iter(params.values())).device
    return {
        "m": {n: torch.zeros(p.shape, dtype=opt.state_dtype, device=p.device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=opt.state_dtype, device=p.device)
              for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in tree.values()))


@torch.no_grad()
def adamw_update(grads: Tree, state: Dict[str, Any], params: Tree,
                 opt: AdamWConfig
                 ) -> Tuple[Tree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Writes the new parameters into ``params`` and the
    new moments into ``state["m"]`` / ``state["v"]`` in place, and returns
    ``(params, {"m", "v", "step": step + 1}, {"grad_norm", "clip"})``.

    The arithmetic is the reference's, in f32: the clip factor
    ``min(1, grad_clip / max(|g|, 1e-12))`` and the bias corrections
    ``1 - b**step`` are f32 tensors, not Python floats.  It is elementwise,
    so each leaf is updated in slices of at most ``SLICE`` elements: the f32
    temporaries of a 256000 x 4096 embedding table would otherwise take
    about 20 GB beside the state."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(opt.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    stepf = step.float()
    f32 = dict(dtype=torch.float32, device=gnorm.device)
    bc1 = 1 - torch.tensor(opt.b1, **f32) ** stepf
    bc2 = 1 - torch.tensor(opt.b2, **f32) ** stepf
    for name, leaf in params.items():
        decay = leaf.ndim >= 2           # decoupled weight decay, matrices only
        flat = (leaf.view(-1), grads[name].reshape(-1),
                state["m"][name].view(-1), state["v"][name].view(-1))
        for lo in range(0, leaf.numel(), SLICE):
            p, g, m, v = (t[lo:lo + SLICE] for t in flat)
            gf = g.float() * clip
            mf = opt.b1 * m.float() + (1 - opt.b1) * gf
            vf = opt.b2 * v.float() + (1 - opt.b2) * gf * gf
            delta = (mf / bc1) / (torch.sqrt(vf / bc2) + opt.eps)
            if decay:
                delta = delta + opt.weight_decay * p.float()
            p.copy_(p.float() - opt.lr * delta)
            m.copy_(mf)
            v.copy_(vf)
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "clip": clip}

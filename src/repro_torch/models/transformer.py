"""Model assembly for decoder LMs built from a block pattern.

Ported from ``repro.models.transformer``.  Block types: ``attn`` (global
causal attention), ``local`` (sliding-window attention with a ring KV
cache), ``rglru`` (RecurrentGemma's recurrent block) and ``mamba`` (mamba1,
mixer only).  Layer ``i`` has type ``cfg.pattern[i % len(cfg.pattern)]``.
The reference scans stacked parameters over super-blocks (one period of the
pattern) and unrolls the remainder; here the layers are an
``nn.ModuleList`` in the same order, so port layer ``s*P + i`` holds index
``s`` of the reference's ``blocks.b{i}`` and layer ``n_super*P + i`` its
``rem{i}`` (see :func:`repro_torch.convert.params_from_reference`).  The
reference's sharding constraints and block-boundary optimization barrier do
nothing on one card and are dropped.  MoE, encoder-decoders and multimodal
frontends raise ``NotImplementedError``.

Entry points, as in the reference:
* :meth:`Transformer.forward`     -- full-sequence logits; differentiable,
  with ``cfg.remat`` checkpointing each super-block as the reference's
  ``jax.checkpoint`` of its scan body does.
* :meth:`Transformer.prefill`     -- runs the prompt, builds the KV / state
  cache, returns last-position logits.
* :meth:`Transformer.decode_step` -- one token against the cache.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

Cache = List[Dict[str, torch.Tensor]]


# ``remat_policy="save_attn"``: the reference names each attention block's
# mixer output (``checkpoint_name(mix, "attn_out")``) and saves only that
# name.  Here that output passes through this identity op, and the
# selective-checkpoint policy saves the op's outputs and recomputes the rest.
@torch.library.custom_op("repro_torch::saved_mixer_out", mutates_args=())
def _saved_mixer_out(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_saved_mixer_out.register_fake
def _(x):
    return torch.empty_like(x)


_saved_mixer_out.register_autograd(lambda ctx, g: g)


def _save_attn_policy(ctx, op, *args, **kwargs):
    if op is torch.ops.repro_torch.saved_mixer_out.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE

# Mixer parameters of each block type: (shapes, in-place initializer).
_MIXERS = {
    "attn": (L.attn_params, L.attn_init_),
    "local": (L.attn_params, L.attn_init_),
    "rglru": (R.rglru_params, R.rglru_init_),
    "mamba": (S.mamba_params, S.mamba_init_),
}


def _pdict(shapes: L.Shapes, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                           requires_grad=False)
        for name, (shape, dtype) in shapes.items()
    })


class Block(nn.Module):
    """One block of type ``btype``: norm1 -> mixer, then norm2 -> FFN except
    for ``mamba``, whose block is norm + mixer only."""

    def __init__(self, btype: str, cfg: ModelConfig, device):
        super().__init__()
        self.btype = btype
        self.norm1 = _pdict(L.norm_params(cfg), device)
        self.mixer = _pdict(_MIXERS[btype][0](cfg), device)
        if btype != "mamba":
            self.norm2 = _pdict(L.norm_params(cfg), device)
            self.ffn = _pdict(L.ffn_params(cfg), device)


def _fill_kv(c: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
             ring: bool) -> None:
    """Write the prompt's K/V into the cache in place.  ``ring``: the cache
    holds the last S_ positions, token t at slot t % S_."""
    S_, T = c["k"].shape[1], k.shape[1]
    if ring:
        # The last S_ chronological KVs are a rotation by T % S_.
        k, v = k[:, -S_:], v[:, -S_:]
        if T >= S_:
            k, v = torch.roll(k, T % S_, dims=1), torch.roll(v, T % S_, dims=1)
    else:
        k, v = k[:, :S_], v[:, :S_]
    c["k"][:, :k.shape[1]] = k
    c["v"][:, :v.shape[1]] = v


class Transformer(nn.Module):
    """Decoder LM; parameters are allocated uninitialized on ``device``.

    Fill them with :func:`init_params` or ``load_state_dict`` (see
    :func:`repro_torch.convert.params_from_reference`).  Parameters do not
    require grad, so serving builds no graph; the trainer
    (:mod:`repro_torch.train.train_step`) turns it on.
    """

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if (cfg.kind != "decoder" or cfg.is_moe or cfg.frontend
                or any(b not in _MIXERS for b in cfg.pattern)):
            raise NotImplementedError(
                f"{cfg.name}: only decoders made of {sorted(_MIXERS)} blocks "
                f"are ported (kind={cfg.kind}, pattern={cfg.pattern}, "
                f"moe_experts={cfg.moe_experts}, frontend={cfg.frontend!r})")
        self.cfg = cfg
        Vp, D = cfg.vocab_padded, cfg.d_model
        self.embed = _pdict({"table": ((Vp, D), cfg.dtype),
                             "head": ((D, Vp), cfg.dtype)}, device)
        P = len(cfg.pattern)
        self.layers = nn.ModuleList(Block(cfg.pattern[i % P], cfg, device)
                                    for i in range(cfg.n_layers))
        self.final_norm = _pdict(L.norm_params(cfg), device)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # -- full sequence --------------------------------------------------------
    def _block(self, blk: Block, x: torch.Tensor, positions: torch.Tensor,
               cache: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """One block over the whole sequence; fills ``cache`` in place when
        given (prefill)."""
        cfg = self.cfg
        h = L.apply_norm(blk.norm1, x, cfg)
        if blk.btype == "mamba":
            mix, st = _mamba_prefill(blk.mixer, h, cfg)
            if cache is not None:
                cache.update(st)
            return x + mix
        if blk.btype == "rglru":
            mix, rec, hT = R.rglru_mix(blk.mixer, h, cfg)
            if cache is not None:
                cache.update(conv=L.conv_tail(rec, R.CONV_W), h=hT)
        else:
            window = cfg.local_window if blk.btype == "local" else 0
            q, k, v = L.attn_qkv(blk.mixer, h, cfg, positions)
            mix = L.attn_out(blk.mixer, ops.flash_attention(
                q, k, v, causal=True, window=window))
            if cfg.remat_policy == "save_attn" and torch.is_grad_enabled():
                mix = _saved_mixer_out(mix)
            if cache is not None:
                _fill_kv(cache, k, v, ring=blk.btype == "local")
        x = x + mix
        h2 = L.apply_norm(blk.norm2, x, cfg)
        return x + L.ffn_forward(blk.ffn, h2, cfg)

    def _super_block(self, s: int, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
        P = len(self.cfg.pattern)
        for blk in self.layers[s * P:(s + 1) * P]:
            x = self._block(blk, x, positions)
        return x

    def forward(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B,T) integer.  Returns (logits (B,T,Vp), moe_aux = 0).

        Under grad with ``cfg.remat``, each super-block (one period of the
        pattern) is a non-reentrant ``torch.utils.checkpoint``: only its
        input is kept, and the backward recomputes it (``remat_policy=
        "save_attn"`` also keeps each mixer output).  The remainder layers
        are not checkpointed, as in the reference."""
        cfg = self.cfg
        x = L.embed(self.embed, tokens, cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        context_fn = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                        _save_attn_policy)
                      if cfg.remat_policy == "save_attn" else ckpt.noop_context_fn)
        for s in range(cfg.n_super):
            if remat:
                x = ckpt.checkpoint(self._super_block, s, x, positions,
                                    use_reentrant=False, context_fn=context_fn,
                                    preserve_rng_state=False)
            else:
                x = self._super_block(s, x, positions)
        P = len(cfg.pattern)
        for blk in self.layers[cfg.n_super * P:]:
            x = self._block(blk, x, positions)
        x = L.apply_norm(self.final_norm, x, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return L.unembed(self.embed, x, cfg), aux

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Cache:
        """Per layer: ``{"k", "v"}`` for attention (a ring of
        ``min(max_len, local_window)`` slots for ``local``), ``{"conv", "h"}``
        for ``rglru`` and ``mamba``."""
        cfg, dev = self.cfg, self.device
        cache: Cache = []
        for blk in self.layers:
            if blk.btype == "rglru":
                cache.append(R.rglru_cache_init(cfg, batch, cfg.dtype, dev))
            elif blk.btype == "mamba":
                cache.append(S.mamba_cache_init(cfg, batch, cfg.dtype, dev))
            else:
                S_ = (min(max_len, cfg.local_window) if blk.btype == "local"
                      else max_len)
                shape = (batch, S_, cfg.n_kv_heads, cfg.head_dim)
                cache.append({"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                              "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)})
        return cache

    def prefill(self, tokens: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt, build the cache, return last-position logits
        (B,1,Vp)."""
        cfg = self.cfg
        B, T = tokens.shape
        x = L.embed(self.embed, tokens, cfg)
        positions = torch.arange(T, device=x.device)
        cache = self.init_cache(B, max_len)
        for blk, c in zip(self.layers, cache):
            x = self._block(blk, x, positions, c)
        x = L.apply_norm(self.final_norm, x[:, -1:], cfg)
        return L.unembed(self.embed, x, cfg), cache

    def decode_step(self, cache: Cache, tokens: torch.Tensor, index: int
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B,1); index: their position.  Returns (logits (B,1,Vp),
        cache); the cache is updated in place."""
        cfg = self.cfg
        x = L.embed(self.embed, tokens, cfg)
        for blk, c in zip(self.layers, cache):
            h = L.apply_norm(blk.norm1, x, cfg)
            if blk.btype == "mamba":
                mix, st = S.mamba_decode(blk.mixer, h, cfg, c)
                c.update(st)
                x = x + mix
                continue
            if blk.btype == "rglru":
                mix, st = R.rglru_decode(blk.mixer, h, cfg, c)
                c.update(st)
            else:
                local = blk.btype == "local"
                mix, c["k"], c["v"] = L.attn_decode(
                    blk.mixer, h, cfg, c["k"], c["v"], index,
                    window=cfg.local_window if local else 0, ring=local)
            x = x + mix
            h2 = L.apply_norm(blk.norm2, x, cfg)
            x = x + L.ffn_forward(blk.ffn, h2, cfg)
        x = L.apply_norm(self.final_norm, x, cfg)
        return L.unembed(self.embed, x, cfg), cache


def _mamba_prefill(p: L.Params, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mamba mixer over the prompt, with its decode state: the last W-1
    pre-conv inputs u (not the conv output) and the final ssm state."""
    out, u, hT = S.mamba_mix(p, x, cfg)
    return out, {"conv": L.conv_tail(u, cfg.ssm_conv), "h": hT}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """A model with the reference's initialization scheme: dense weights
    N(0,1)/sqrt(fan_in) drawn in f32 and cast to ``cfg.dtype``; norm and
    qk-norm scales 1, biases 0; the recurrent mixers' constants as in
    ``repro.models.ssm.mamba_init`` and ``repro.models.rglru.rglru_init``.
    ``generator`` must live on ``device``.
    """
    model = Transformer(cfg, device=device)
    D = cfg.d_model
    with torch.no_grad():
        L.dense_(model.embed["table"], D, generator)
        L.dense_(model.embed["head"], D, generator)
        L.norm_init_(model.final_norm)
        for blk in model.layers:
            L.norm_init_(blk.norm1)
            _MIXERS[blk.btype][1](blk.mixer, cfg, generator)
            if blk.btype != "mamba":
                L.norm_init_(blk.norm2)
                L.ffn_init_(blk.ffn, cfg, generator)
    return model

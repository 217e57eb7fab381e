"""Model assembly: decoder LMs and encoder-decoders from block patterns.

Ported from ``repro.models.transformer``.  Block types: ``attn`` (global
causal attention), ``local`` (sliding-window attention with a ring KV
cache), ``rglru`` (RecurrentGemma's recurrent block) and ``mamba`` (mamba1,
mixer only; with ``cfg.mamba_ffn``, Jamba's, norm2 and an FFN after the
mixer as in the other blocks, so a serving cache holds a mamba state beside
the attention layers' K/V).  Layer ``i`` has type ``cfg.pattern[i % len(cfg.pattern)]``.
With ``cfg.is_moe`` a block's FFN is the mixture of experts of
:mod:`repro_torch.models.moe`, and ``forward`` returns its load-balance
loss summed over the layers.  An encoder-decoder (``kind="encdec"``,
whisper) adds ``cfg.enc_layers`` bidirectional MHA encoder layers over the
stub audio frames and, in each decoder block, cross-attention to their
output after the mixer; its serving cache holds each layer's cross K/V
(``ck``, ``cv``).  A vision arch (``frontend="vision"``, paligemma)
projects the stub patch embeddings and prepends them to the tokens, so a
sequence of T tokens runs as P + T positions.
The reference scans stacked parameters over super-blocks (one period of the
pattern) and unrolls the remainder; here the layers are an
``nn.ModuleList`` in the same order, so port layer ``s*P + i`` holds index
``s`` of the reference's ``blocks.b{i}`` and layer ``n_super*P + i`` its
``rem{i}``; encoder layer ``j`` holds index ``j`` of ``enc_blocks`` (see
:func:`repro_torch.convert.params_from_reference`).
:func:`param_specs` and :func:`cache_specs` give the reference's logical
sharding specs on that layout: layer ``s*P + i`` takes the spec of
``blocks.b{i}`` without its stacked leading ``None``.  Under a mesh
(:func:`repro_torch.models.sharding.active_rules`, with the parameters and
inputs DTensors placed by :mod:`repro_torch.launch.mesh`) the reference's
activation constraints apply where it applies them: the residual stream at
the input and at each super-block boundary (over the sequence too with
``cfg.seq_parallel``), each encoder layer, and the logits (vocab over the
model axis).  Without a mesh they are no-ops.  The reference's
optimization barrier at the boundary only pins XLA's fusion and has no
counterpart.

Entry points, as in the reference:
* :meth:`Transformer.forward`     -- full-sequence logits; differentiable,
  with ``cfg.remat`` checkpointing each layer of a super-block (and each
  encoder layer); the reference's ``jax.checkpoint`` of its scan bodies
  takes a whole super-block, which is the same for a one-layer pattern.
* :meth:`Transformer.prefill`     -- runs the prompt, builds the KV / state
  cache, returns last-position logits.
* :meth:`Transformer.decode_step` -- one token against the cache.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models import sharding as sh
from repro_torch.models.sharding import (P, local_offset, shard, to_local_at,
                                         under_rules)

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


_FRONTENDS = ("", "audio", "vision")

_MIXER_SPECS = {"attn": L.attn_spec, "local": L.attn_spec,
                "rglru": R.rglru_spec, "mamba": S.mamba_spec}


def _block_spec(btype: str, cfg: ModelConfig, cross: bool) -> Dict[str, Dict[str, P]]:
    p = {"norm1": L.norm_spec(cfg), "mixer": _MIXER_SPECS[btype](cfg)}
    if btype != "mamba" or cfg.mamba_ffn:
        if cross:
            p["norm_c"] = L.norm_spec(cfg)
            p["cross"] = L.attn_spec(cfg)
        p["norm2"] = L.norm_spec(cfg)
        p["ffn"] = M.moe_spec(cfg) if cfg.is_moe else L.ffn_spec(cfg)
    return p


def param_specs(cfg: ModelConfig) -> Dict[str, P]:
    """The logical sharding spec of every parameter, keyed as
    ``Transformer.named_parameters`` names it."""
    cross = cfg.kind == "encdec"
    groups = {"embed": L.embed_spec(cfg), "final_norm": L.norm_spec(cfg)}
    Pn = len(cfg.pattern)
    for i in range(cfg.n_layers):
        for g, spec in _block_spec(cfg.pattern[i % Pn], cfg, cross).items():
            groups[f"layers.{i}.{g}"] = spec
    if cross:
        for j in range(cfg.enc_layers):
            for g, spec in _block_spec("attn", _enc_cfg(cfg), False).items():
                groups[f"enc_layers.{j}.{g}"] = spec
        groups["enc_final_norm"] = L.norm_spec(cfg)
    out = {f"{g}.{n}": s for g, spec in groups.items() for n, s in spec.items()}
    if cfg.frontend == "vision":
        out["patch_proj"] = P("fsdp", "model")
    return out


def cache_specs(cfg: ModelConfig) -> List[Dict[str, P]]:
    """The logical sharding spec of each layer's serving cache, in the
    layout of ``Transformer.init_cache``."""
    out = []
    for i in range(cfg.n_layers):
        btype = cfg.pattern[i % len(cfg.pattern)]
        if btype == "rglru":
            c = R.rglru_cache_spec(cfg)
        elif btype == "mamba":
            c = S.mamba_cache_spec(cfg)
        else:
            c = {"k": P("batch", "seq", "model_kv", None),
                 "v": P("batch", "seq", "model_kv", None)}
        if cfg.kind == "encdec":
            c["ck"] = P("batch", "seq", "model", None)
            c["cv"] = P("batch", "seq", "model", None)
        out.append(c)
    return out


def _boundary(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The residual stream's constraint at the input and at each super-block
    boundary: batch-sharded, and over the sequence too with
    ``cfg.seq_parallel``."""
    if cfg.seq_parallel and x.shape[1] > 1:
        return shard(x, "batch", "seq", None)
    return shard(x, "batch", None, None)


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """Whisper encoder: same width, bidirectional MHA (kv == heads)."""
    return dataclasses.replace(cfg, n_kv_heads=cfg.n_heads)


class Block(nn.Module):
    """One block of type ``btype``: norm1 -> mixer, with ``cross`` norm_c ->
    cross-attention, then norm2 -> FFN (the experts when ``cfg.is_moe``);
    a ``mamba`` block is norm + mixer only unless ``cfg.mamba_ffn``."""

    def __init__(self, btype: str, cfg: ModelConfig, device,
                 cross: bool = False):
        super().__init__()
        self.btype = btype
        self.norm1 = _pdict(L.norm_params(cfg), device)
        self.mixer = _pdict(_MIXERS[btype][0](cfg), device)
        if btype != "mamba" or cfg.mamba_ffn:
            if cross:
                self.norm_c = _pdict(L.norm_params(cfg), device)
                self.cross = _pdict(L.attn_params(cfg), device)
            self.norm2 = _pdict(L.norm_params(cfg), device)
            self.ffn = _pdict(M.moe_params(cfg) if cfg.is_moe
                              else L.ffn_params(cfg), device)


def _fill_kv(c: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
             ring: bool) -> None:
    """Write the prompt's K/V into the cache in place.  ``ring``: the cache
    holds the last S_ positions, token t at slot t % S_.  A DTensor cache
    is written shard by shard: each rank takes K/V on its batch and head
    shards (whole over the sequence) and writes the slots of its own
    sequence shard."""
    S_, T = c["k"].shape[1], k.shape[1]
    sharded = isinstance(c["k"], DTensor)
    if sharded:
        mesh, cpl = c["k"].device_mesh, c["k"].placements
        kpl = tuple(Replicate() if p == Shard(1) else p for p in cpl)
        k, v = to_local_at(k, mesh, kpl), to_local_at(v, mesh, kpl)
    if ring:
        # The last S_ chronological KVs are a rotation by T % S_.
        k, v = k[:, -S_:], v[:, -S_:]
        if T >= S_:
            k, v = torch.roll(k, T % S_, dims=1), torch.roll(v, T % S_, dims=1)
    else:
        k, v = k[:, :S_], v[:, :S_]
    if not sharded:
        c["k"][:, :k.shape[1]] = k
        c["v"][:, :v.shape[1]] = v
        return
    off = local_offset(c["k"], 1)
    ck, cv = c["k"].to_local(), c["v"].to_local()
    lo, hi = off, min(off + ck.shape[1], k.shape[1])
    if hi > lo:
        ck[:, :hi - lo] = k[:, lo:hi]
        cv[:, :hi - lo] = v[:, lo:hi]


class Transformer(nn.Module):
    """Decoder LM or encoder-decoder; parameters are allocated uninitialized
    on ``device``.

    Fill them with :func:`init_params` or ``load_state_dict`` (see
    :func:`repro_torch.convert.params_from_reference`).  Parameters do not
    require grad, so serving builds no graph; the trainer
    (:mod:`repro_torch.train.train_step`) turns it on.
    """

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if (cfg.kind not in ("decoder", "encdec") or cfg.frontend not in _FRONTENDS
                or any(b not in _MIXERS for b in cfg.pattern)):
            raise NotImplementedError(
                f"{cfg.name}: the port builds decoders and encoder-decoders "
                f"of {sorted(_MIXERS)} blocks with frontends {_FRONTENDS} "
                f"(kind={cfg.kind}, pattern={cfg.pattern}, "
                f"frontend={cfg.frontend!r})")
        self.cfg = cfg
        Vp, D = cfg.vocab_padded, cfg.d_model
        self.embed = _pdict({"table": ((Vp, D), cfg.dtype),
                             "head": ((D, Vp), cfg.dtype)}, device)
        P = len(cfg.pattern)
        cross = cfg.kind == "encdec"
        self.layers = nn.ModuleList(Block(cfg.pattern[i % P], cfg, device, cross)
                                    for i in range(cfg.n_layers))
        self.final_norm = _pdict(L.norm_params(cfg), device)
        if cross:
            self.enc_cfg = _enc_cfg(cfg)
            self.enc_layers = nn.ModuleList(Block("attn", self.enc_cfg, device)
                                            for _ in range(cfg.enc_layers))
            self.enc_final_norm = _pdict(L.norm_params(cfg), device)
        if cfg.frontend == "vision":
            self.patch_proj = nn.Parameter(
                torch.empty((D, D), dtype=cfg.dtype, device=device),
                requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # -- full sequence --------------------------------------------------------
    def _block(self, blk: Block, x: torch.Tensor, positions: torch.Tensor,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               enc_out: Optional[torch.Tensor] = None,
               cfg: Optional[ModelConfig] = None, causal: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One block over the whole sequence: (x, the MoE's aux loss or
        None).  Fills ``cache`` in place when given (prefill); ``enc_out``
        adds cross-attention to it; ``cfg`` and ``causal`` default to the
        decoder's."""
        cfg = cfg or self.cfg
        h = L.apply_norm(blk.norm1, x, cfg)
        if blk.btype == "mamba":
            mix, st = _mamba_prefill(blk.mixer, h, cfg)
            if cache is not None:
                _update(cache, st)
            if not cfg.mamba_ffn:
                return x + mix, None
        elif blk.btype == "rglru":
            mix, rec, hT = R.rglru_mix(blk.mixer, h, cfg)
            if cache is not None:
                _update(cache, {"conv": L.conv_tail(rec, R.CONV_W), "h": hT})
        else:
            window = cfg.local_window if blk.btype == "local" else 0
            q, k, v = L.attn_qkv(blk.mixer, h, cfg, positions)
            mix = L.attn_out(blk.mixer, ops.flash_attention(
                q, k, v, causal=causal, window=window))
            if cfg.remat_policy == "save_attn" and torch.is_grad_enabled():
                mix = _saved_mixer_out(mix)
            if cache is not None:
                _fill_kv(cache, k, v, ring=blk.btype == "local")
        x = x + mix
        if enc_out is not None:
            # Cross-attention: queries from the decoder, K/V from the
            # encoder output, no RoPE, no mask.
            hc = L.apply_norm(blk.norm_c, x, cfg)
            q, k, v = L.attn_qkv(blk.cross, hc, cfg, None, kv_from=enc_out)
            x = x + L.attn_out(blk.cross, ops.flash_attention(q, k, v,
                                                              causal=False))
            if cache is not None:
                _update(cache, {"ck": k, "cv": v})
        h2 = L.apply_norm(blk.norm2, x, cfg)
        if cfg.is_moe:
            y, aux = M.moe_forward(blk.ffn, h2, cfg)
            return x + y, aux
        return x + L.ffn_forward(blk.ffn, h2, cfg), None

    @under_rules
    def _super_block_layer(self, i: int, x: torch.Tensor, positions: torch.Tensor,
                           enc_out: Optional[torch.Tensor]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``i`` of a super-block: (x, its MoE aux loss or 0), x under
        the boundary's constraint after a super-block's last layer."""
        x, a = self._block(self.layers[i], x, positions, enc_out=enc_out)
        if a is None:
            a = torch.zeros((), dtype=torch.float32, device=x.device)
        P = len(self.cfg.pattern)
        return (_boundary(x, self.cfg) if i % P == P - 1 else x), a

    @under_rules
    def _enc_block(self, j: int, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        x = self._block(self.enc_layers[j], x, positions, cfg=self.enc_cfg,
                        causal=False)[0]
        return shard(x, "batch", None, None)

    def _encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over (B, S, D) frames: bidirectional attention with
        RoPE positions 0..S-1, as the reference's ``attn_forward`` gives
        them; each layer checkpointed under grad with ``cfg.remat``."""
        x = shard(frames, "batch", None, None)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for j in range(len(self.enc_layers)):
            if remat:
                x = ckpt.checkpoint(self._enc_block, j, x, positions,
                                    use_reentrant=False, preserve_rng_state=False)
            else:
                x = self._enc_block(j, x, positions)
        return L.apply_norm(self.enc_final_norm, x, self.cfg)

    def _inputs(self, tokens: torch.Tensor, frames: Optional[torch.Tensor],
                patches: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the embedded sequence, with the projected patches in front for a
        vision arch; the encoder output for an encoder-decoder given
        frames, else None)."""
        cfg = self.cfg
        x = L.embed(self.embed, tokens, cfg)
        if cfg.frontend == "vision" and patches is not None:
            pe = patches.to(cfg.dtype)
            pe = sh.product(pe, self.patch_proj)
            x = torch.cat([pe, x], dim=1)
        enc_out = (self._encode(frames) if cfg.kind == "encdec"
                   and frames is not None else None)
        return x, enc_out

    def forward(self, tokens: torch.Tensor,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B,T) integer.  Returns (logits (B,T',Vp), moe_aux f32).

        ``frames``: (B, enc_len, D) stub audio embeddings (whisper);
        ``patches``: (B, P, D) stub vision embeddings (paligemma), projected
        and prepended, so T' = P + T.  ``moe_aux`` sums each layer's
        load-balance loss in the reference's order (super-blocks, then the
        remainder); 0 without experts.

        Under grad with ``cfg.remat``, each layer of a super-block (one
        period of the pattern) is a non-reentrant ``torch.utils.checkpoint``:
        only its input is kept, and the backward recomputes it
        (``remat_policy="save_attn"`` also keeps each mixer output).  The
        reference checkpoints a whole super-block; layer by layer holds one
        layer's activations at a time in the recompute, which a long period
        (Jamba's 14 layers) needs, and recomputes the same.  The remainder
        layers are not checkpointed, as in the reference."""
        cfg = self.cfg
        x, enc_out = self._inputs(tokens, frames, patches)
        x = _boundary(x, cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        context_fn = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                        _save_attn_policy)
                      if cfg.remat_policy == "save_attn" else ckpt.noop_context_fn)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        P = len(cfg.pattern)
        for i in range(cfg.n_super * P):
            if remat:
                x, a = ckpt.checkpoint(self._super_block_layer, i, x, positions, enc_out,
                                       use_reentrant=False, context_fn=context_fn,
                                       preserve_rng_state=False)
            else:
                x, a = self._super_block_layer(i, x, positions, enc_out)
            aux = aux + a
        for blk in self.layers[cfg.n_super * P:]:
            x, a = self._block(blk, x, positions, enc_out=enc_out)
            if a is not None:
                aux = aux + a
        x = L.apply_norm(self.final_norm, x, cfg)
        return shard(L.unembed(self.embed, x, cfg), "batch", None, "vocab"), aux

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Cache:
        """Per layer: ``{"k", "v"}`` for attention (a ring of
        ``min(max_len, local_window)`` slots for ``local``), ``{"conv", "h"}``
        for ``rglru`` and ``mamba``; an encoder-decoder's also hold the
        cross K/V ``{"ck", "cv"}`` (B, enc_len, n_heads, head_dim), zero
        until prefill fills them.  Under :func:`sharding.active_rules` each
        leaf is a DTensor at its :func:`cache_specs` placements, made on the
        shards."""
        cfg, dev = self.cfg, self.device
        cache: Cache = []
        for blk, spec in zip(self.layers, cache_specs(cfg)):
            if blk.btype == "rglru":
                c = R.rglru_cache_init(cfg, batch, cfg.dtype, dev)
            elif blk.btype == "mamba":
                c = S.mamba_cache_init(cfg, batch, cfg.dtype, dev)
            else:
                S_ = (min(max_len, cfg.local_window) if blk.btype == "local"
                      else max_len)
                shape = (batch, S_, cfg.n_kv_heads, cfg.head_dim)
                c = {n: sh.zeros(shape, cfg.dtype, dev, spec[n]) for n in ("k", "v")}
            if cfg.kind == "encdec":
                shape = (batch, cfg.enc_len, cfg.n_heads, cfg.head_dim)
                c.update({n: sh.zeros(shape, cfg.dtype, dev, spec[n])
                          for n in ("ck", "cv")})
            cache.append(c)
        return cache

    def prefill(self, tokens: torch.Tensor, max_len: int,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt (after the projected patches of a vision arch),
        build the cache, return last-position logits (B,1,Vp).  The cache
        holds positions 0..max_len-1: a vision arch's P patches take the
        first P, so decoding starts at index P + T."""
        cfg = self.cfg
        x, enc_out = self._inputs(tokens, frames, patches)
        x = shard(x, "batch", None, None)
        positions = torch.arange(x.shape[1], device=x.device)
        cache = self.init_cache(tokens.shape[0], max_len)
        ends = _super_block_ends(cfg)
        for i, (blk, c) in enumerate(zip(self.layers, cache)):
            x, _ = self._block(blk, x, positions, c, enc_out=enc_out)
            if i in ends:
                x = _boundary(x, cfg)
        x = L.apply_norm(self.final_norm, x[:, -1:], cfg)
        return shard(L.unembed(self.embed, x, cfg), "batch", None, "vocab"), cache

    def decode_step(self, cache: Cache, tokens: torch.Tensor, index: int
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B,1); index: their position.  Returns (logits (B,1,Vp),
        cache); the cache is updated in place."""
        cfg = self.cfg
        x = shard(L.embed(self.embed, tokens, cfg), "batch", None, None)
        ends = _super_block_ends(cfg)
        for i, (blk, c) in enumerate(zip(self.layers, cache)):
            x = self._decode_block(blk, x, c, index)
            if i in ends:
                x = shard(x, "batch", None, None)
        x = L.apply_norm(self.final_norm, x, cfg)
        return shard(L.unembed(self.embed, x, cfg), "batch", None, "vocab"), cache

    def _decode_block(self, blk: Block, x: torch.Tensor,
                      c: Dict[str, torch.Tensor], index: int) -> torch.Tensor:
        """One block for one token, updating its cache ``c`` in place."""
        cfg = self.cfg
        h = L.apply_norm(blk.norm1, x, cfg)
        if blk.btype == "mamba":
            mix, st = S.mamba_decode(blk.mixer, h, cfg, c)
            _update(c, st)
            if not cfg.mamba_ffn:
                return x + mix
        elif blk.btype == "rglru":
            mix, st = R.rglru_decode(blk.mixer, h, cfg, c)
            _update(c, st)
        else:
            local = blk.btype == "local"
            mix, c["k"], c["v"] = L.attn_decode(
                blk.mixer, h, cfg, c["k"], c["v"], index,
                window=cfg.local_window if local else 0, ring=local)
        x = x + mix
        if "ck" in c:      # cross-attention against the encoder's K/V
            hc = L.apply_norm(blk.norm_c, x, cfg)
            x = x + L.attn_out(blk.cross, _cross_decode(
                blk.cross, hc, cfg, c["ck"], c["cv"]))
        h2 = L.apply_norm(blk.norm2, x, cfg)
        if cfg.is_moe:
            return x + M.moe_forward(blk.ffn, h2, cfg)[0]
        return x + L.ffn_forward(blk.ffn, h2, cfg)


def _update(c: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]) -> None:
    """Replace cache leaves; a sharded leaf keeps its placements."""
    for name, t in new.items():
        c[name] = sh.like_placed(c[name], t)


def _super_block_ends(cfg: ModelConfig) -> set:
    """Indices of the layers that end a super-block (not the remainder)."""
    Pn = len(cfg.pattern)
    return {s * Pn + Pn - 1 for s in range(cfg.n_super)}


def _cross_decode(p: L.Params, x: torch.Tensor, cfg: ModelConfig,
                  ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """One query per sequence against the whole cross cache.  As the
    reference's ``_cross_decode``: the query projection and qk-norm, without
    the q bias."""
    q = L._heads(x, p["wq"])
    if cfg.qk_norm:
        q = L._qk_normalize(q, p["q_norm"])
    return ops.decode_attention(q, ck, cv, ck.shape[1])


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
    ``repro.models.ssm.mamba_init`` and ``repro.models.rglru.rglru_init``;
    the experts and router as ``repro.models.moe.moe_init``; the patch
    projection with fan-in d_model.  ``generator`` must live on ``device``.
    """
    model = Transformer(cfg, device=device)
    D = cfg.d_model
    with torch.no_grad():
        L.dense_(model.embed["table"], D, generator)
        L.dense_(model.embed["head"], D, generator)
        L.norm_init_(model.final_norm)
        blocks = [(blk, cfg) for blk in model.layers]
        if cfg.kind == "encdec":
            blocks += [(blk, model.enc_cfg) for blk in model.enc_layers]
            L.norm_init_(model.enc_final_norm)
        for blk, bcfg in blocks:
            L.norm_init_(blk.norm1)
            _MIXERS[blk.btype][1](blk.mixer, bcfg, generator)
            if blk.btype == "mamba" and not bcfg.mamba_ffn:
                continue
            if hasattr(blk, "cross"):
                L.norm_init_(blk.norm_c)
                L.attn_init_(blk.cross, bcfg, generator)
            L.norm_init_(blk.norm2)
            if bcfg.is_moe:
                M.moe_init_(blk.ffn, bcfg, generator)
            else:
                L.ffn_init_(blk.ffn, bcfg, generator)
        if cfg.frontend == "vision":
            L.dense_(model.patch_proj, D, generator)
    return model

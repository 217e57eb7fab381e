"""Model assembly for dense attention decoders (block pattern ``("attn",)``).

Ported from ``repro.models.transformer``.  The reference scans stacked
per-layer parameters; here the layers are an ``nn.ModuleList``, so layer
``i`` holds what the reference keeps at index ``i`` of ``blocks.b0``.  The
reference's sharding constraints and block-boundary optimization barrier
do nothing on one card and are dropped.  Other block patterns, MoE,
encoder-decoders and multimodal frontends raise ``NotImplementedError``.

Entry points, as in the reference:
* :meth:`Transformer.forward`     -- full-sequence logits.
* :meth:`Transformer.prefill`     -- runs the prompt, builds the KV cache,
  returns last-position logits.
* :meth:`Transformer.decode_step` -- one token against the cache.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Cache = List[Dict[str, torch.Tensor]]


def _pdict(shapes: Dict[str, tuple], dtypes: Dict[str, torch.dtype],
           device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, dtype=dtypes[name],
                                       device=device), requires_grad=False)
        for name, shape in shapes.items()
    })


def _norm(cfg: ModelConfig, device) -> nn.ParameterDict:
    names = ("scale", "bias") if cfg.norm == "layernorm" else ("scale",)
    return _pdict({n: (cfg.d_model,) for n in names},
                  {n: torch.float32 for n in names}, device)


class Block(nn.Module):
    """One attention block: norm1 -> attention -> norm2 -> FFN."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        D, H, K, hd, Fd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff)
        mixer = {"wq": (D, H, hd), "wk": (D, K, hd), "wv": (D, K, hd),
                 "wo": (H, hd, D)}
        dtypes = {n: cfg.dtype for n in mixer}
        if cfg.qkv_bias:
            mixer.update(bq=(H, hd), bk=(K, hd), bv=(K, hd))
        if cfg.qk_norm:
            mixer.update(q_norm=(hd,), k_norm=(hd,))
        dtypes.update({n: torch.float32 for n in mixer if n not in dtypes})
        ffn = {"wi": (D, Fd), "wo": (Fd, D)}
        if cfg.ffn in ("swiglu", "geglu"):
            ffn["wg"] = (D, Fd)
        self.norm1 = _norm(cfg, device)
        self.mixer = _pdict(mixer, dtypes, device)
        self.norm2 = _norm(cfg, device)
        self.ffn = _pdict(ffn, {n: cfg.dtype for n in ffn}, device)


class Transformer(nn.Module):
    """Decoder LM; parameters are allocated uninitialized on ``device``.

    Fill them with :func:`init_params` or ``load_state_dict`` (see
    :func:`repro_torch.convert.params_from_reference`).
    """

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if (cfg.kind != "decoder" or tuple(cfg.pattern) != ("attn",)
                or cfg.is_moe or cfg.frontend):
            raise NotImplementedError(
                f"{cfg.name}: only dense decoders with pattern ('attn',) are "
                f"ported (kind={cfg.kind}, pattern={cfg.pattern}, "
                f"moe_experts={cfg.moe_experts}, frontend={cfg.frontend!r})")
        self.cfg = cfg
        Vp, D = cfg.vocab_padded, cfg.d_model
        self.embed = _pdict({"table": (Vp, D), "head": (D, Vp)},
                            {"table": cfg.dtype, "head": cfg.dtype}, device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _norm(cfg, device)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # -- full sequence --------------------------------------------------------
    def _block(self, blk: Block, x: torch.Tensor, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One block over the whole sequence; returns (x, k, v)."""
        cfg = self.cfg
        h = L.apply_norm(blk.norm1, x, cfg)
        q, k, v = L.attn_qkv(blk.mixer, h, cfg, positions)
        x = x + L.attn_out(blk.mixer, ops.flash_attention(q, k, v, causal=True))
        h2 = L.apply_norm(blk.norm2, x, cfg)
        return x + L.ffn_forward(blk.ffn, h2, cfg), k, v

    def forward(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: (B,T) integer.  Returns (logits (B,T,Vp), moe_aux = 0)."""
        cfg = self.cfg
        x = L.embed(self.embed, tokens, cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        for blk in self.layers:
            x, _, _ = self._block(blk, x, positions)
        x = L.apply_norm(self.final_norm, x, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return L.unembed(self.embed, x, cfg), aux

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Cache:
        cfg = self.cfg
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device)}
                for _ in self.layers]

    def prefill(self, tokens: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt, build the cache, return last-position logits
        (B,1,Vp)."""
        cfg = self.cfg
        B, T = tokens.shape
        x = L.embed(self.embed, tokens, cfg)
        positions = torch.arange(T, device=x.device)
        cache = self.init_cache(B, max_len)
        n = min(T, max_len)
        for blk, c in zip(self.layers, cache):
            x, k, v = self._block(blk, x, positions)
            c["k"][:, :n] = k[:, :n]
            c["v"][:, :n] = v[:, :n]
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
            mix, c["k"], c["v"] = L.attn_decode(blk.mixer, h, cfg, c["k"],
                                                c["v"], index)
            x = x + mix
            h2 = L.apply_norm(blk.norm2, x, cfg)
            x = x + L.ffn_forward(blk.ffn, h2, cfg)
        x = L.apply_norm(self.final_norm, x, cfg)
        return L.unembed(self.embed, x, cfg), cache


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """A model with the reference's initialization scheme: dense weights
    N(0,1)/sqrt(fan_in) drawn in f32 and cast to ``cfg.dtype``; norm and
    qk-norm scales 1, biases 0.  ``generator`` must live on ``device``.
    """
    model = Transformer(cfg, device=device)
    D = cfg.d_model
    fan_in = {("embed", "table"): D, ("embed", "head"): D,
              ("mixer", "wq"): D, ("mixer", "wk"): D, ("mixer", "wv"): D,
              ("mixer", "wo"): cfg.n_heads * cfg.head_dim,
              ("ffn", "wi"): D, ("ffn", "wg"): D, ("ffn", "wo"): cfg.d_ff}
    with torch.no_grad():
        for name, p in model.named_parameters():
            group, leaf = name.split(".")[-2:]
            if (group, leaf) in fan_in:
                w = torch.randn(p.shape, generator=generator,
                                dtype=torch.float32, device=p.device)
                p.copy_(w * fan_in[group, leaf] ** -0.5)
                del w
            elif leaf in ("scale", "q_norm", "k_norm"):
                p.fill_(1.0)
            else:
                p.zero_()
    return model

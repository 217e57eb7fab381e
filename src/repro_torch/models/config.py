"""Architecture configuration schema, copied from ``repro.models.config``.

Field names, defaults and derived properties are the reference's; only the
two dtype fields hold ``torch`` dtypes (bf16 weights, f32 optimizer state).
:class:`HybridConfig` adds the port-only switches of a hybrid Mamba /
attention model (Jamba); on a :class:`ModelConfig` they read as their
defaults, so every reference config, and its fields, stay as they are.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Exact assigned values live in ``repro_torch.configs``.

    ``pattern`` is one period of the block layout, cycled over the depth
    (recurrentgemma: ``("rglru", "rglru", "local")``; mamba: ``("mamba",)``;
    plain transformers: ``("attn",)``).
    """

    name: str
    kind: str                       # "decoder" | "encdec"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    pattern: Tuple[str, ...] = ("attn",)
    ffn: str = "swiglu"             # swiglu | geglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    local_window: int = 0           # window for "local" / rglru-attn blocks
    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_capacity: float = 1.25
    moe_impl: str = "sort_scatter"  # sort_scatter | a2a
    # SSM (mamba1)
    ssm_state: int = 16
    ssm_conv: int = 4
    d_inner: int = 0                # 0 -> 2*d_model
    dt_rank: int = 0                # 0 -> ceil(d_model/16)
    # RG-LRU
    lru_width: int = 0              # 0 -> d_model
    # Encoder-decoder (whisper)
    enc_layers: int = 0
    enc_len: int = 1500
    # Multimodal stub frontend: "" | "audio" | "vision"
    frontend: str = ""
    vision_patches: int = 256
    # Embedding/head tables are padded to a multiple of this; the padded
    # slots are masked to -1e30 in unembed, so argmax is unchanged.
    pad_vocab_to: int = 512
    # Precision / distribution policy
    dtype: Any = torch.bfloat16
    policy: str = "tp"
    fsdp: bool = False
    remat: bool = True
    seq_parallel: bool = False
    remat_policy: str = "full"
    opt_state_dtype: Any = torch.float32
    microbatches: int = 1

    # Port-only switches, plain class attributes so that a reference config's
    # fields stay the reference's; :class:`HybridConfig` makes them fields.
    mamba_ffn = False               # mamba blocks carry norm2 and an FFN
    mamba_dt_bc_norm = False        # RMSNorms on the mixer's dt, B and C
    use_rope = True                 # attention rotates q and k

    # ---- derived -----------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        m = max(self.pad_vocab_to, 1)
        return -(-self.vocab // m) * m

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def dtrank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def lru(self) -> int:
        return self.lru_width or self.d_model

    @property
    def n_super(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def remainder(self) -> Tuple[str, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True iff decode state does not grow with context (SSM / local)."""
        return all(b in ("mamba", "rglru", "local") for b in self.pattern)

    def params_total(self) -> int:
        """Exact parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        n = V * D                                    # embedding
        n += V * D                                   # lm head (untied)
        per: dict = {}
        per["attn"] = D * (H + 2 * K) * hd + H * hd * D
        if self.qkv_bias:
            per["attn"] += (H + 2 * K) * hd
        if self.qk_norm:
            per["attn"] += 2 * hd
        per["local"] = per["attn"]
        ffn = (3 if self.ffn in ("swiglu", "geglu") else 2) * D * F
        if self.is_moe:
            ffn = self.moe_experts * ffn + D * self.moe_experts
        L = self.lru
        per["rglru"] = 2 * D * L + 2 * L * L + L + L * D + self.ssm_conv * L
        I, R, N = self.inner, self.dtrank, self.ssm_state
        per["mamba"] = (D * 2 * I + self.ssm_conv * I + I * (R + 2 * N)
                        + R * I + I * N + I + I * D)
        counts = {b: 0 for b in set(self.pattern)}
        for i in range(self.n_layers):
            counts[self.pattern[i % len(self.pattern)]] += 1
        for b, c in counts.items():
            n += c * (per[b] + 2 * D)                # + norms
            if b != "mamba":                         # mamba blocks: mixer only
                n += c * ffn
        n += 2 * D                                   # final norm
        if self.kind == "encdec":
            enc = self.enc_layers * (per["attn"] + ffn + 4 * D)
            dec_cross = self.n_layers * (per["attn"] + 2 * D)
            n += enc + dec_cross
        return n

    def params_active(self) -> int:
        """Active parameters per token (MoE: top-k of the experts)."""
        if not self.is_moe:
            return self.params_total()
        dense = replace(self, moe_experts=0, moe_topk=0)
        ffn = (3 if self.ffn in ("swiglu", "geglu") else 2) * self.d_model * self.d_ff
        return dense.params_total() + self.n_layers * (
            ffn * self.moe_topk + self.d_model * self.moe_experts
        ) - self.n_layers * ffn


@dataclass(frozen=True)
class HybridConfig(ModelConfig):
    """A :class:`ModelConfig` with the port-only switches as fields
    (AI21's Jamba: ``modeling_jamba``'s ``JambaMambaDecoderLayer``,
    ``JambaMambaMixer`` and ``JambaAttention``).

    * ``mamba_ffn``: a ``mamba`` block is ``x += mixer(norm1(x))`` then
      ``x += ffn(norm2(x))``, as an attention block is;
    * ``mamba_dt_bc_norm``: the mixer takes an RMSNorm with a learned scale
      over each of dt (width ``dtrank``), B and C (width ``ssm_state``)
      after ``x_proj`` (``dt_layernorm``, ``b_layernorm``, ``c_layernorm``);
    * ``use_rope``: False leaves q and k unrotated (Jamba's attention has no
      positional encoding).
    """

    mamba_ffn: bool = False
    mamba_dt_bc_norm: bool = False
    use_rope: bool = True

    def params_total(self) -> int:
        """Every leaf as the port holds it, the embedding and head at the
        unpadded vocabulary.  The reference's count, which
        :meth:`ModelConfig.params_total` keeps for the reference's configs,
        leaves out a mamba mixer's conv and dt biases and counts two vectors
        for the final norm; here each is counted as held, with the FFN of a
        mamba block under ``mamba_ffn`` and its dt, B and C norms under
        ``mamba_dt_bc_norm``.  Blocks of ``attn``, ``local`` and ``mamba``."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        I, R, N = self.inner, self.dtrank, self.ssm_state
        norm = 2 * D if self.norm == "layernorm" else D
        attn = D * (H + 2 * K) * hd + H * hd * D
        attn += (H + 2 * K) * hd if self.qkv_bias else 0
        attn += 2 * hd if self.qk_norm else 0
        mamba = (D * 2 * I + self.ssm_conv * I + I + I * (R + 2 * N) + R * I + I
                 + I * N + I + I * D)
        mamba += R + 2 * N if self.mamba_dt_bc_norm else 0
        ffn = (3 if self.ffn in ("swiglu", "geglu") else 2) * D * F
        if self.is_moe:
            ffn = self.moe_experts * ffn + D * self.moe_experts
        per = {"attn": attn + 2 * norm + ffn, "local": attn + 2 * norm + ffn,
               "mamba": mamba + norm + ((norm + ffn) if self.mamba_ffn else 0)}
        bad = set(self.pattern) - set(per)
        if bad or self.kind != "decoder":
            raise NotImplementedError(f"{self.name}: counts decoders of {sorted(per)}")
        n = 2 * V * D + norm
        for i in range(self.n_layers):
            n += per[self.pattern[i % len(self.pattern)]]
        return n


@dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell."""

    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    mode: str                       # "train" | "prefill" | "decode"


TRAIN_4K = ShapeCell("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeCell, ...]:
    """The live cells for an arch: long_500k only if sub-quadratic decode."""
    cells = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        cells.append(LONG_500K)
    return tuple(cells)

"""AI21-Jamba2-3B [hybrid]: 28L d_model=2560, Mamba-1 mixers with attention
at layers 7 and 21 (``attn_layer_period`` 14, ``attn_layer_offset`` 7),
20 query heads over 1 KV head of dim 128 and no RoPE, a dense SwiGLU FFN
of 8192 after every mixer, mamba d_inner=5120 (expand 2), d_state=16,
d_conv=4, dt_rank=160 with RMSNorms on dt, B and C, vocab=65536
(https://huggingface.co/ai21labs/AI21-Jamba2-3B, ``model_type: jamba``).

Port-only (:class:`repro_torch.models.config.HybridConfig`); the reference
has no Jamba, so it is not among ``registry.ARCHS``.  The published head is
tied to the embedding; the port holds an untied head.
"""

from repro_torch.models.config import HybridConfig

PATTERN = ("mamba",) * 7 + ("attn",) + ("mamba",) * 6

CONFIG = HybridConfig(
    name="jamba2-3b",
    kind="decoder",
    n_layers=28,
    d_model=2560,
    n_heads=20,
    n_kv_heads=1,
    d_head=128,
    d_ff=8192,
    vocab=65536,
    pattern=PATTERN,
    ffn="swiglu",
    norm="rmsnorm",
    d_inner=5120,
    ssm_state=16,
    ssm_conv=4,
    dt_rank=160,
    mamba_ffn=True,
    mamba_dt_bc_norm=True,
    use_rope=False,
    policy="tp",
)

TINY = HybridConfig(
    name="jamba2-tiny",
    kind="decoder",
    n_layers=4,
    d_model=32,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=64,
    vocab=128,
    pattern=("mamba", "attn", "mamba"),
    ffn="swiglu",
    norm="rmsnorm",
    d_inner=64,
    ssm_state=4,
    ssm_conv=4,
    dt_rank=8,
    mamba_ffn=True,
    mamba_dt_bc_norm=True,
    use_rope=False,
    policy="tp",
)

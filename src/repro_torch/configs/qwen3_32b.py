"""qwen3-32b [dense]: 64L d_model=5120 64H (kv=8) d_ff=25600 vocab=151936,
qk-norm, head_dim=128 (q projects 5120 -> 64*128) [hf:Qwen/Qwen3-8B family].

Field-equal to ``repro.configs.qwen3_32b``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    kind="decoder",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    policy="tp",
    fsdp=True,
    microbatches=16,
)

TINY = ModelConfig(
    name="qwen3-tiny",
    kind="decoder",
    n_layers=2,
    d_model=32,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=64,
    vocab=128,
    qk_norm=True,
    policy="tp",
)

"""starcoder2-3b [dense]: 30L d_model=3072 24H (kv=2) d_ff=12288
vocab=49152, RoPE, layernorm + gelu FFN [arXiv:2402.19173].

Field-equal to ``repro.configs.starcoder2_3b``.  ``policy="fsdp"`` names
its sharding rules (:func:`repro_torch.models.sharding.rules_for`): under a
mesh every activation shards its batch over both axes and the weights are
stored sharded over both; on one card the field is unused.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    kind="decoder",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_head=128,
    d_ff=12288,
    vocab=49152,
    norm="layernorm",
    ffn="gelu",
    policy="fsdp",
)

TINY = ModelConfig(
    name="starcoder2-tiny",
    kind="decoder",
    n_layers=2,
    d_model=32,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=64,
    vocab=128,
    norm="layernorm",
    ffn="gelu",
    policy="fsdp",
)

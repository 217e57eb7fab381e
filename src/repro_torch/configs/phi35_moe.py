"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (kv=8) d_ff=6400/expert,
vocab=32064, 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct].

Field-equal to ``repro.configs.phi35_moe``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    kind="decoder",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    moe_experts=16,
    moe_topk=2,
    policy="tp",
    fsdp=True,
    microbatches=16,
)

TINY = ModelConfig(
    name="phi35-moe-tiny",
    kind="decoder",
    n_layers=2,
    d_model=32,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab=128,
    moe_experts=4,
    moe_topk=2,
    moe_capacity=2.0,
    policy="tp",
)

"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (kv=8) d_ff=512/expert,
vocab=49155, 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base].

Field-equal to ``repro.configs.granite_moe_1b``.  ``moe_impl="a2a"``: under a
mesh the experts split over the model axis with two all-to-alls per layer;
without one it takes ``sort_scatter`` (:mod:`repro_torch.models.moe`).  The
vocab is padded to 49664 (``pad_vocab_to``), which a 2- or 16-way model axis
divides, so the embedding and the logits split over it.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    kind="decoder",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe_experts=32,
    moe_impl="a2a",
    microbatches=8,
    moe_topk=8,
    policy="tp",
    fsdp=True,
)

TINY = ModelConfig(
    name="granite-moe-tiny",
    kind="decoder",
    n_layers=2,
    d_model=32,
    n_heads=4,
    n_kv_heads=2,
    d_ff=16,
    vocab=128,
    moe_experts=4,
    moe_topk=2,
    moe_capacity=2.0,
    policy="tp",
)

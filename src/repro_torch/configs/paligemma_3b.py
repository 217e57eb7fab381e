"""paligemma-3b [vlm]: SigLIP frontend STUB + gemma decoder.

18L d_model=2048 8H (kv=1, MQA) d_ff=16384 vocab=257216
[arXiv:2407.07726].  Field-equal to ``repro.configs.paligemma_3b``: the
SigLIP tower is stubbed by precomputed patch embeddings (256 patches for
224px/14), projected and prepended to the token sequence, and attention is
causal over the whole (prefix + text) sequence where PaliGemma's prefix is
bidirectional.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    kind="decoder",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab=257216,
    ffn="geglu",
    frontend="vision",
    vision_patches=256,
    policy="fsdp",
    microbatches=16,
)

TINY = ModelConfig(
    name="paligemma-tiny",
    kind="decoder",
    n_layers=2,
    d_model=32,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=64,
    vocab=128,
    ffn="geglu",
    frontend="vision",
    vision_patches=4,
    policy="fsdp",
)

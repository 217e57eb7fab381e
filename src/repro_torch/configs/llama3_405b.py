"""llama3-405b [dense]: 126L d_model=16384 128H (kv=8) d_ff=53248
vocab=128256 [arXiv:2407.21783].

Field-equal to ``repro.configs.llama3_405b``, with ``opt_state_dtype``
bf16 as ``torch.bfloat16``: the reference keeps parameters, gradients and
both AdamW moments in bf16 to fit 405B parameters on its chips.  On one
card a run cuts the depth (``--layers``).
"""

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    kind="decoder",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_head=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=500_000.0,
    policy="tp",
    fsdp=True,
    opt_state_dtype=torch.bfloat16,
    microbatches=16,
)

TINY = ModelConfig(
    name="llama3-tiny",
    kind="decoder",
    n_layers=2,
    d_model=32,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=64,
    vocab=128,
    policy="tp",
)

"""falcon-mamba-7b [ssm]: 64L d_model=4096, attention-free mamba1 blocks,
d_inner=8192, ssm_state=16, vocab=65024 [arXiv:2410.05355].

O(1) decode state (conv window + (I,N) ssm state) -> RUNS long_500k.
Field-equal to ``repro.configs.falcon_mamba_7b``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    kind="decoder",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    pattern=("mamba",),
    d_inner=8192,
    ssm_state=16,
    ssm_conv=4,
    policy="tp",
    fsdp=True,
    microbatches=8,
)

TINY = ModelConfig(
    name="falcon-mamba-tiny",
    kind="decoder",
    n_layers=2,
    d_model=32,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=128,
    pattern=("mamba",),
    d_inner=64,
    ssm_state=4,
    ssm_conv=4,
    policy="tp",
)

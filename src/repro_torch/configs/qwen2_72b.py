"""qwen2-72b [dense]: 80L d_model=8192 64H (kv=8) d_ff=29568 vocab=152064,
QKV bias [arXiv:2407.10671].

Field-equal to ``repro.configs.qwen2_72b``.  Its ``microbatches=8`` and
``fsdp=True`` size the reference's multi-chip train step; on one card the
fields are carried, and ``--microbatches`` / ``--layers`` set what a run
uses.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    kind="decoder",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    policy="tp",
    fsdp=True,
    microbatches=8,
)

TINY = ModelConfig(
    name="qwen2-tiny",
    kind="decoder",
    n_layers=2,
    d_model=32,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=64,
    vocab=128,
    qkv_bias=True,
    policy="tp",
)

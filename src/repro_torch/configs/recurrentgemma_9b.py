"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (kv=1) d_ff=12288
vocab=256000 -- RG-LRU + local attention, pattern 2 recurrent : 1 local
[arXiv:2402.19427].  38 = 12 x (rglru,rglru,local) + 2 rglru remainder.

Sub-quadratic decode state (LRU hidden + 2048-window ring KV) -> this
arch RUNS the long_500k cell.  Field-equal to
``repro.configs.recurrentgemma_9b``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    kind="decoder",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    pattern=("rglru", "rglru", "local"),
    local_window=2048,
    ffn="geglu",
    policy="tp",
    fsdp=True,
    microbatches=4,
)

TINY = ModelConfig(
    name="recurrentgemma-tiny",
    kind="decoder",
    n_layers=5,                    # 1 super-block + (rglru, rglru) remainder
    d_model=32,
    n_heads=4,
    n_kv_heads=1,
    d_ff=64,
    vocab=128,
    pattern=("rglru", "rglru", "local"),
    local_window=8,
    ffn="geglu",
    policy="tp",
)

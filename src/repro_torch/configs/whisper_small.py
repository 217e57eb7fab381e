"""whisper-small [audio]: enc-dec, conv frontend stubbed (frame embeddings).

12L(dec)+12L(enc) d_model=768 12H (kv=12, i.e. MHA) d_ff=3072 vocab=51865
[arXiv:2212.04356].  Field-equal to ``repro.configs.whisper_small``, with
its deviations: RoPE instead of learned/sinusoidal positions; pre-LN
layernorm; gelu FFN as in the paper.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    kind="encdec",
    n_layers=12,
    enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    norm="layernorm",
    ffn="gelu",
    frontend="audio",
    enc_len=1500,
    policy="dp",
)

TINY = ModelConfig(
    name="whisper-small-tiny",
    kind="encdec",
    n_layers=2,
    enc_layers=2,
    d_model=32,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab=128,
    norm="layernorm",
    ffn="gelu",
    frontend="audio",
    enc_len=8,
    policy="dp",
)

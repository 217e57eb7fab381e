"""``--arch <id>`` registry.  Only the ported architectures resolve.

The names of the reference's other architectures are known, so asking for
one of them says it is not yet ported rather than that it does not exist.
"""

from repro_torch.configs import (falcon_mamba_7b, llama3_405b, qwen2_72b,
                                 qwen3_32b, recurrentgemma_9b, starcoder2_3b)
from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen3-32b": qwen3_32b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "starcoder2-3b": starcoder2_3b,
    "qwen2-72b": qwen2_72b,
    "llama3-405b": llama3_405b,
}

NOT_YET_PORTED = (
    "whisper-small", "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
    "paligemma-3b",
)

ARCHS = {name: mod.CONFIG for name, mod in _MODULES.items()}


def _module(name: str):
    if name in _MODULES:
        return _MODULES[name]
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported; ported: {sorted(ARCHS)}")
    raise ValueError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def tiny_config(name: str) -> ModelConfig:
    return _module(name).TINY

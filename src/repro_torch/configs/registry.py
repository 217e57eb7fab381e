"""``--arch <id>`` registry: the reference's ten architectures."""

from repro_torch.configs import (falcon_mamba_7b, granite_moe_1b, llama3_405b,
                                 paligemma_3b, phi35_moe, qwen2_72b, qwen3_32b,
                                 recurrentgemma_9b, starcoder2_3b,
                                 whisper_small)
from repro_torch.models.config import ModelConfig

_MODULES = {          # the reference's order, which --list prints
    "whisper-small": whisper_small,
    "granite-moe-1b-a400m": granite_moe_1b,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "recurrentgemma-9b": recurrentgemma_9b,
    "qwen3-32b": qwen3_32b,
    "llama3-405b": llama3_405b,
    "qwen2-72b": qwen2_72b,
    "starcoder2-3b": starcoder2_3b,
    "paligemma-3b": paligemma_3b,
    "falcon-mamba-7b": falcon_mamba_7b,
}

# Every architecture of the reference is ported.
NOT_YET_PORTED: tuple = ()

ARCHS = {name: mod.CONFIG for name, mod in _MODULES.items()}


def _module(name: str):
    if name in _MODULES:
        return _MODULES[name]
    raise ValueError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def tiny_config(name: str) -> ModelConfig:
    return _module(name).TINY

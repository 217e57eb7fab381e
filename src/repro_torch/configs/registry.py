"""``--arch <id>`` registry: the reference's ten architectures
(``ARCHS``) and the port's own (``PORT_ARCHS``), which the reference has
not; ``--arch`` takes the names of both (``ARCH_NAMES``)."""

from repro_torch.configs import (falcon_mamba_7b, granite_moe_1b, jamba2_3b,
                                 llama3_405b, paligemma_3b, phi35_moe,
                                 qwen2_72b, qwen3_32b, recurrentgemma_9b,
                                 starcoder2_3b, whisper_small)
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

_PORT_MODULES = {"jamba2-3b": jamba2_3b}
PORT_ARCHS = {name: mod.CONFIG for name, mod in _PORT_MODULES.items()}
ARCH_NAMES = tuple(sorted(ARCHS) + sorted(PORT_ARCHS))


def _module(name: str):
    mod = _MODULES.get(name) or _PORT_MODULES.get(name)
    if mod is None:
        raise ValueError(f"unknown arch {name!r}; choose from {list(ARCH_NAMES)}")
    return mod


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def tiny_config(name: str) -> ModelConfig:
    return _module(name).TINY

"""Model registry: name → ModelConfig (the llama and Gemma families; the
Mixtral entries wait for the MoE slice)."""

from __future__ import annotations

from typing import Dict, List

from pilottai_tpu_torch.models import gemma, llama
from pilottai_tpu_torch.models.common import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}


def register_model(config: ModelConfig) -> None:
    _REGISTRY[config.name] = config


for _cfg in (
    llama.LLAMA3_8B,
    llama.LLAMA3_1B,
    llama.LLAMA3_8B_BYTE,
    llama.LLAMA3_1B_BYTE,
    llama.LLAMA_TINY,
    llama.PROTOCOL_S,
    llama.PROTOCOL_XS,
    gemma.GEMMA_2B,
    gemma.GEMMA2_2B,
    gemma.GEMMA_2B_BYTE,
    gemma.GEMMA_TINY,
):
    register_model(_cfg)


def get_model_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_models() -> List[str]:
    return sorted(_REGISTRY)

"""Model registry: name → ModelConfig (llama family of this slice)."""

from __future__ import annotations

from typing import Dict, List

from pilottai_tpu_torch.models import llama
from pilottai_tpu_torch.models.common import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {
    cfg.name: cfg
    for cfg in (
        llama.LLAMA3_8B,
        llama.LLAMA3_1B,
        llama.LLAMA3_8B_BYTE,
        llama.LLAMA3_1B_BYTE,
        llama.LLAMA_TINY,
        llama.PROTOCOL_S,
        llama.PROTOCOL_XS,
    )
}


def get_model_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_models() -> List[str]:
    return sorted(_REGISTRY)

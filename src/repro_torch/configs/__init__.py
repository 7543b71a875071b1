"""Configurations: the paper's benchmarks and the model registry.

``get_config(name)`` resolves an ``--arch`` id to a
:class:`~repro_torch.configs.base.ModelConfig` (copied as data from
``repro.configs``); :mod:`repro_torch.configs.paper_eneac` holds the
paper's HOTSPOT and SPMM configurations.
"""

from typing import Dict, List

from .base import ModelConfig
from .grok_1_314b import CONFIG as _grok
from .llama3_2_3b import CONFIG as _llama3
from .llama3_2_vision_90b import CONFIG as _vision
from .mamba2_130m import CONFIG as _mamba2
from .qwen3_14b import CONFIG as _qwen3
from .qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from .recurrentgemma_9b import CONFIG as _rgemma
from .stablelm_12b import CONFIG as _stablelm
from .tinyllama_1_1b import CONFIG as _tinyllama
from .whisper_large_v3 import CONFIG as _whisper

__all__ = ["ModelConfig", "get_config", "all_configs", "ARCH_NAMES"]

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in (_stablelm, _tinyllama, _qwen3, _llama3, _whisper, _mamba2, _grok,
              _qwen3moe, _vision, _rgemma)
}

ARCH_NAMES: List[str] = list(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    return dict(_REGISTRY)

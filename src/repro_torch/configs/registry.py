"""Architecture registry: ``--arch <id>`` -> ArchConfig, the JAX package's
ten ids, each with its config copied field for field."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ArchConfig, reduced

_MODULES = {
    "qwen3-0.6b": "qwen3_0_6b",
    "xlstm-125m": "xlstm_125m",
    "zamba2-2.7b": "zamba2_2_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "whisper-tiny": "whisper_tiny",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "yi-34b": "yi_34b",
    "command-r-35b": "command_r_35b",
    "nemotron-4-340b": "nemotron_4_340b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_reduced_config(arch_id: str, **kw) -> ArchConfig:
    """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
    return reduced(get_config(arch_id), **kw)


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}

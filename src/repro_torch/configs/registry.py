"""Architecture registry: ``--arch <id>`` -> (full config, smoke twin)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import SHAPES, shape_applicable  # noqa: F401

_MODULES = {
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_4p2b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> dict[str, ModelConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}

"""Architecture registry: the 10 assigned configs + reduced smoke variants."""
from importlib import import_module

from .base import SHAPES, ModelConfig, param_count

_MODULES = {
    "deepseek-coder-33b": "deepseek_coder_33b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "tinyllama-1.1b": "tinyllama_1p1b",
    "qwen1.5-4b": "qwen1p5_4b",
    "hymba-1.5b": "hymba_1p5b",
    "whisper-medium": "whisper_medium",
    "paligemma-3b": "paligemma_3b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-1.3b": "mamba2_1p3b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def get_reduced(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").reduced()


__all__ = ["ARCH_NAMES", "SHAPES", "ModelConfig", "get_config", "get_reduced", "param_count"]

"""Architecture config registry of the port.

A copy of ``repro.configs``: the same ten architectures, names and order.
Each lives in its own module exposing ``CONFIG``; ``get_config(name)``
resolves it and raises ``KeyError`` for an unknown name.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import (INPUT_SHAPES, ModelConfig,  # noqa: F401
                                       ShapeConfig)

_ARCHS = (
    "whisper_tiny",
    "tinyllama_1_1b",
    "internvl2_2b",
    "grok_1_314b",
    "granite_34b",
    "llama3_2_1b",
    "hymba_1_5b",
    "qwen3_moe_235b_a22b",
    "rwkv6_7b",
    "qwen2_5_32b",
)

_ALIASES = {
    "whisper-tiny": "whisper_tiny",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "internvl2-2b": "internvl2_2b",
    "grok-1-314b": "grok_1_314b",
    "granite-34b": "granite_34b",
    "llama3.2-1b": "llama3_2_1b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "rwkv6-7b": "rwkv6_7b",
    "qwen2.5-32b": "qwen2_5_32b",
}


def list_archs():
    return list(_ALIASES.keys())


def canonical_names():
    """The exact assigned ids."""
    return list(_ALIASES.keys())


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in _ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{canonical_names()}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]

"""Architecture config registry of the port.

Same names as ``repro.configs``.  Only the architectures whose path the
port runs are here; every other name raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_PORTED = (
    "tinyllama_1_1b",
    "grok_1_314b",
    "granite_34b",
    "llama3_2_1b",
    "qwen3_moe_235b_a22b",
    "rwkv6_7b",
    "qwen2_5_32b",
)

# the JAX package's names, in its order
_ALIASES = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "grok-1-314b": "grok_1_314b",
    "granite-34b": "granite_34b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "rwkv6-7b": "rwkv6_7b",
    "qwen2.5-32b": "qwen2_5_32b",
}


def list_archs():
    return list(_ALIASES.keys())


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in _PORTED:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet; ported: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG

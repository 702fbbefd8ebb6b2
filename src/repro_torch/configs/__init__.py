"""Architecture config registry of the port.

Same names as ``repro.configs``.  Only the architectures whose path the
port runs are here; every other name raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_PORTED = ("llama3_2_1b", "rwkv6_7b")

_ALIASES = {
    "llama3.2-1b": "llama3_2_1b",
    "rwkv6-7b": "rwkv6_7b",
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

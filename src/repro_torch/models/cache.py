"""KV-cache construction for the families whose decode state is K and V.

Same layout as ``repro.models.cache``: every entry stacked on a leading
layer axis, (L, B, S, Hkv, Dh).  The decode step writes into it in place.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models.config import ModelConfig

# families whose decode state is the KV cache alone
_KV_FAMILIES = ("dense", "moe", "vlm")


def kv_cache_dtype(cfg: ModelConfig) -> torch.dtype:
    """``cfg.kv_cache_dtype`` ("" = the model's dtype); fp8 caches are
    upcast on read."""
    if not cfg.kv_cache_dtype:
        return torch_dtype(cfg.dtype)
    if cfg.kv_cache_dtype == "float8_e4m3fn":
        return torch.float8_e4m3fn
    return torch_dtype(cfg.kv_cache_dtype)


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               device: DeviceLike = None) -> dict:
    """Zeroed {"k", "v"} of shape (L, batch, seq, Hkv, Dh) on ``device``
    (default: the card)."""
    if cfg.family not in _KV_FAMILIES:
        raise NotImplementedError(
            f"decode state of the {cfg.family!r} family is not ported yet")
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    dt = kv_cache_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}

"""Decode-state construction: the KV cache, or the rwkv6 state.

Same layout as ``repro.models.cache``: every entry stacked on a leading
layer axis, K and V as (L, B, S, Hkv, Dh); for the ssm family the float32
WKV state (L, B, H, Dh, Dh) and the last normed token of the time mix and
of the channel mix, (L, B, 1, d) in the model's dtype.  The decode step
writes into it in place.
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
    """Zeroed {"k", "v"} of shape (L, batch, seq, Hkv, Dh), or for the
    ssm family {"wkv", "shift_t", "shift_c"}, on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    if cfg.family == "ssm":
        L, H, Dh, d = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.d_model
        dt = torch_dtype(cfg.dtype)
        return {"wkv": torch.zeros((L, batch, H, Dh, Dh),
                                   dtype=torch.float32, device=dev),
                "shift_t": torch.zeros((L, batch, 1, d), dtype=dt,
                                       device=dev),
                "shift_c": torch.zeros((L, batch, 1, d), dtype=dt,
                                       device=dev)}
    if cfg.family not in _KV_FAMILIES:
        raise NotImplementedError(
            f"decode state of the {cfg.family!r} family is not ported yet")
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    dt = kv_cache_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}

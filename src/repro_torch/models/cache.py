"""Decode-state construction: the KV cache, and each family's state.

Same layout as ``repro.models.cache``: every entry stacked on a leading
layer axis, K and V as (L, B, S, Hkv, Dh) for every family with attention;
encdec adds the cross K/V ``xk``/``xv`` (L, B, enc_seq, Hkv, Dh) in the KV
dtype, hybrid the mamba conv state ``conv`` (L, B, K-1, Di) in the model's
dtype and the float32 SSM state ``ssm`` (L, B, Di, N); the ssm family has
the float32 WKV state (L, B, H, Dh, Dh) and the last normed token of the
time mix and of the channel mix, (L, B, 1, d) in the model's dtype.  The
decode step writes into it in place.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import mamba
from repro_torch.models.config import ModelConfig


def kv_cache_dtype(cfg: ModelConfig) -> torch.dtype:
    """``cfg.kv_cache_dtype`` ("" = the model's dtype); fp8 caches are
    upcast on read."""
    if not cfg.kv_cache_dtype:
        return torch_dtype(cfg.dtype)
    if cfg.kv_cache_dtype == "float8_e4m3fn":
        return torch.float8_e4m3fn
    return torch_dtype(cfg.kv_cache_dtype)


def _entries(cfg: ModelConfig, batch: int, seq: int):
    """(name, shape, logical axes, dtype) of each entry, in the JAX
    package's order and with its axes (``repro.models.cache.init_cache``)."""
    dt = torch_dtype(cfg.dtype)
    kvdt = kv_cache_dtype(cfg)
    L, B = cfg.n_layers, batch
    out = []
    if cfg.family != "ssm":
        kv_shape = (L, B, seq, cfg.n_kv_heads, cfg.head_dim)
        kv_axes = ("layer", "batch", "seq", "kv_heads", None)
        out += [("k", kv_shape, kv_axes, kvdt), ("v", kv_shape, kv_axes, kvdt)]
    if cfg.family == "encdec":
        xshape = (L, B, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
        xaxes = ("layer", "batch", None, "kv_heads", None)
        out += [("xk", xshape, xaxes, kvdt), ("xv", xshape, xaxes, kvdt)]
    if cfg.family == "ssm":
        out += [("wkv", (L, B, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                 ("layer", "batch", "heads", None, None), torch.float32),
                ("shift_t", (L, B, 1, cfg.d_model),
                 ("layer", "batch", None, "d_model"), dt),
                ("shift_c", (L, B, 1, cfg.d_model),
                 ("layer", "batch", None, "d_model"), dt)]
    if cfg.family == "hybrid":
        di = mamba.d_inner(cfg)
        out += [("conv", (L, B, mamba.CONV_K - 1, di),
                 ("layer", "batch", None, "d_ff"), dt),
                ("ssm", (L, B, di, cfg.ssm_state),
                 ("layer", "batch", "d_ff", None), torch.float32)]
    return out


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               device: DeviceLike = None) -> dict:
    """The zeroed decode state of ``cfg``'s family (the module docstring),
    with the JAX package's names in its order, on ``device`` (default:
    the card).  ``device="meta"`` gives its shapes with no memory (the JAX
    package's ``abstract=True``)."""
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, shape, _, dtype in _entries(cfg, batch, seq)}


def cache_axes(cfg: ModelConfig) -> dict:
    """The logical axes of each cache entry, the JAX package's
    (``init_cache``'s second tree), leading ``"layer"`` axis included, as
    the port's cache keeps it."""
    return {name: axes for name, _, axes, _ in _entries(cfg, 1, 1)}

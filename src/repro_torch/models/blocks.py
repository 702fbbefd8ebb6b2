"""Per-layer blocks: parameters and the prefill / decode functions.

``block_fwd(cfg, window)(block, x, positions)`` -> (x, aux)
``block_decode(cfg, window, seq_sharded)(block, cache_k, cache_v, x, pos)``
-> x, with the layer's cache slices updated in place.
Only the dense family with llama's options is ported (no QKV bias, tied
embeddings); anything else raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm, swiglu


def _require_ported(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"blocks of the {cfg.family!r} family are not ported yet")
    if cfg.qkv_bias or not cfg.tie_embeddings:
        raise NotImplementedError(
            "QKV bias and untied embeddings are not ported yet")


class DenseBlock(nn.Module):
    """One dense layer's parameters, with the JAX package's names and
    per-layer shapes (its stacked arrays without the leading layer axis).
    Created uninitialised; ``model.init_params`` or
    ``convert.params_from_numpy`` fills them."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        _require_ported(cfg)
        d, f, H, Hkv, Dh = (cfg.d_model, cfg.d_ff, cfg.n_heads,
                            cfg.n_kv_heads, cfg.head_dim)
        shapes = {"ln1": (d,), "ln2": (d,),
                  "wq": (d, H, Dh), "wk": (d, Hkv, Dh), "wv": (d, Hkv, Dh),
                  "wo": (H, Dh, d),
                  "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))


def block_fwd(cfg: ModelConfig, window: int):
    """Returns f(block, x, positions) -> (x, aux)."""
    _require_ported(cfg)
    eps = cfg.norm_eps

    def dense(p: DenseBlock, x, positions):
        h = rmsnorm(x, p.ln1, eps)
        x = x + attn.self_attention(p, h, cfg, positions, window)
        h = rmsnorm(x, p.ln2, eps)
        x = x + swiglu(h, p.w_gate, p.w_up, p.w_down)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    return dense


def block_decode(cfg: ModelConfig, window: int, seq_sharded: bool):
    """Returns f(block, cache_k, cache_v, x, pos) -> x; the layer's cache
    slices (B,S,Hkv,Dh) are written in place."""
    _require_ported(cfg)
    eps = cfg.norm_eps

    def dense(p: DenseBlock, cache_k, cache_v, x, pos):
        h = rmsnorm(x, p.ln1, eps)
        out, _, _ = attn.decode_self_attention(
            p, h, cfg, cache_k, cache_v, pos, window, seq_sharded)
        x = x + out
        h = rmsnorm(x, p.ln2, eps)
        return x + swiglu(h, p.w_gate, p.w_up, p.w_down)

    return dense

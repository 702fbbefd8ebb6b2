"""Per-layer blocks: parameters and the prefill / decode functions.

``block_fwd(cfg, window)(block, x, positions)`` -> (x, aux)
``block_decode(cfg, window, seq_sharded)(block, c, x, pos)`` -> x, where
``c`` is the layer's cache as a dict of slices, written in place.
Ported: the dense family with llama's options (no QKV bias) and the ssm
family (rwkv6); anything else raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import rwkv
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm, swiglu

# How ``model.init_params`` fills a parameter: "ones", "zeros", or the std
# of a normal draw.
Init = Union[str, float]
Specs = Dict[str, Tuple[Tuple[int, ...], Init]]


def fan_in(*shape: int) -> Tuple[Tuple[int, ...], Init]:
    """A normal draw of std 1/sqrt(shape[-2]): the JAX ``ParamFactory``
    default, whose stacked shapes have the same second-to-last dim."""
    return shape, 1.0 / math.sqrt(max(1, shape[-2]))


def register_params(module: nn.Module, specs: Specs, device: torch.device,
                    dtype: torch.dtype):
    """Uninitialised, frozen parameters of the given shapes on ``module``."""
    for name, (shape, _) in specs.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device),
            requires_grad=False))


def _require_ported(cfg: ModelConfig):
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"blocks of the {cfg.family!r} family are not ported yet")
    if cfg.qkv_bias:
        raise NotImplementedError("QKV bias is not ported yet")


class _Block(nn.Module):
    """One layer's parameters, with the JAX package's names and per-layer
    shapes (its stacked arrays without the leading layer axis).  Created
    uninitialised; ``model.init_params`` or ``convert.params_from_numpy``
    fills them."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        _require_ported(cfg)
        register_params(self, self.specs(cfg), device, dtype)


class DenseBlock(_Block):
    @staticmethod
    def specs(cfg: ModelConfig) -> Specs:
        """``repro.models.blocks.init_blocks`` and ``attention.init_attn``."""
        d, f, H, Hkv, Dh = (cfg.d_model, cfg.d_ff, cfg.n_heads,
                            cfg.n_kv_heads, cfg.head_dim)
        return {"ln1": ((d,), "ones"), "ln2": ((d,), "ones"),
                "wq": fan_in(d, H, Dh), "wk": fan_in(d, Hkv, Dh),
                "wv": fan_in(d, Hkv, Dh), "wo": fan_in(H, Dh, d),
                "w_gate": fan_in(d, f), "w_up": fan_in(d, f),
                "w_down": fan_in(f, d)}


class RWKVBlock(_Block):
    @staticmethod
    def specs(cfg: ModelConfig) -> Specs:
        """``repro.models.blocks.init_blocks`` (blocks.py:29-33) and
        ``rwkv.init_rwkv`` (rwkv.py:31-43): the time-mix anchors ``mu``,
        the decay base ``w0``, the bonus ``u`` and the channel-mix anchors
        ``mu_c`` start at zero."""
        d, f, H, Dh, R = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim,
                          rwkv.LORA_R)
        return {"ln1": ((d,), "ones"), "ln2": ((d,), "ones"),
                "mu": ((5, d), "zeros"), "w0": ((d,), "zeros"),
                "wa": fan_in(d, R), "wb": fan_in(R, d),
                "u": ((H, Dh), "zeros"),
                "wr": fan_in(d, d), "wk": fan_in(d, d), "wv": fan_in(d, d),
                "wg": fan_in(d, d), "wo": fan_in(d, d),
                "ln_x": ((d,), "ones"), "mu_c": ((2, d), "zeros"),
                "wk_c": fan_in(d, f), "wv_c": fan_in(f, d),
                "wr_c": fan_in(d, d)}


def norm_fn(cfg: ModelConfig):
    """The RMSNorm of ``forward``: kernel K3 (``ops.rmsnorm``) on the
    kernel path (``attn_impl == "pallas"``), the plain norm otherwise.
    ``decode_step`` always takes the plain norm, as the JAX package's
    decode reaches no kernel."""
    return ops.rmsnorm if cfg.attn_impl == "pallas" else rmsnorm


def block_fwd(cfg: ModelConfig, window: int):
    """Returns f(block, x, positions) -> (x, aux)."""
    _require_ported(cfg)
    eps = cfg.norm_eps
    norm = norm_fn(cfg)

    def dense(p: DenseBlock, x, positions):
        h = norm(x, p.ln1, eps)
        x = x + attn.self_attention(p, h, cfg, positions, window)
        h = norm(x, p.ln2, eps)
        x = x + swiglu(h, p.w_gate, p.w_up, p.w_down)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def ssm(p: RWKVBlock, x, positions):
        B, _, d = x.shape
        zshift = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
        zstate = torch.zeros((B, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                             dtype=torch.float32, device=x.device)
        h = norm(x, p.ln1, eps)
        y, _, _ = rwkv.time_mix(p, h, cfg, zshift, zstate, cfg.attn_impl)
        x = x + y
        h = norm(x, p.ln2, eps)
        y, _ = rwkv.channel_mix(p, h, zshift)
        return x + y, torch.zeros((), dtype=torch.float32, device=x.device)

    return ssm if cfg.family == "ssm" else dense


def block_decode(cfg: ModelConfig, window: int, seq_sharded: bool):
    """Returns f(block, c, x, pos) -> x; ``c`` maps the names of the
    layer's cache entries to their slices, which are written in place."""
    _require_ported(cfg)
    eps = cfg.norm_eps

    def dense(p: DenseBlock, c, x, pos):
        h = rmsnorm(x, p.ln1, eps)
        out, _, _ = attn.decode_self_attention(
            p, h, cfg, c["k"], c["v"], pos, window, seq_sharded)
        x = x + out
        h = rmsnorm(x, p.ln2, eps)
        return x + swiglu(h, p.w_gate, p.w_up, p.w_down)

    def ssm(p: RWKVBlock, c, x, pos):
        # One step of the plain scan, as the JAX package's decode does
        # (``time_mix`` with its default impl, blocks.py:184): the kernel
        # serves the prefill ``forward`` only, whatever cfg.attn_impl says.
        h = rmsnorm(x, p.ln1, eps)
        y, shift_t, wkv = rwkv.time_mix(p, h, cfg, c["shift_t"], c["wkv"])
        c["shift_t"].copy_(shift_t)
        c["wkv"].copy_(wkv)
        x = x + y
        h = rmsnorm(x, p.ln2, eps)
        y, shift_c = rwkv.channel_mix(p, h, c["shift_c"])
        c["shift_c"].copy_(shift_c)
        return x + y

    return ssm if cfg.family == "ssm" else dense

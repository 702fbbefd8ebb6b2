"""Per-layer blocks: parameters and the prefill / decode functions.

``block_fwd(cfg, window)(block, x, positions, extra)`` -> (x, aux), where
``extra`` is the encdec layer's cross K/V and None for the others;
``encoder_block_fwd(cfg)(block, x, positions)`` -> x;
``block_decode(cfg, window, seq_sharded)(block, c, x, pos)`` -> x, where
``c`` is the layer's cache as a dict of slices, written in place.
Every family of the JAX package: dense and vlm (with or without QKV
bias), moe, ssm (rwkv6), hybrid (attention beside a mamba mix) and encdec
(LayerNorms, cross attention, a GELU MLP, and the encoder's blocks).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import mamba, moe, rwkv
from repro_torch.models import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Spec, Specs, fan_in, gelu_mlp,
                                       layernorm, rmsnorm, spec, swiglu)


def register_params(module: nn.Module, specs: Specs, device: torch.device,
                    dtype: torch.dtype):
    """Uninitialised, frozen parameters of the given shapes on ``module``."""
    for name, sp in specs.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(sp.shape, dtype=dtype, device=device),
            requires_grad=False))


class _Block(nn.Module):
    """One layer's parameters, with the JAX package's names and per-layer
    shapes (its stacked arrays without the leading layer axis).  Created
    uninitialised; ``model.init_params`` or ``convert.params_from_numpy``
    fills them."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        register_params(self, self.specs(cfg), device, dtype)


D = ("d_model",)


def _ones(n: int, axes=D) -> Spec:
    return spec((n,), "ones", axes)


def _zeros(shape, axes=D) -> Spec:
    return spec(shape if isinstance(shape, tuple) else (shape,), "zeros",
                axes)


def _attn_specs(cfg: ModelConfig, pre: str = "") -> Specs:
    """``repro.models.attention.init_attn``: the projections, and with
    ``cfg.qkv_bias`` the biases ``bq`` (H, Dh), ``bk`` and ``bv`` (Hkv, Dh),
    which start at zero; every name prefixed with ``pre`` ("x" for the
    cross attention)."""
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {"wq": fan_in((d, H, Dh), ("d_model", "heads", None)),
             "wk": fan_in((d, Hkv, Dh), ("d_model", "kv_heads", None)),
             "wv": fan_in((d, Hkv, Dh), ("d_model", "kv_heads", None)),
             "wo": fan_in((H, Dh, d), ("heads", None, "d_model"))}
    if cfg.qkv_bias:
        specs.update(bq=_zeros((H, Dh), ("heads", None)),
                     bk=_zeros((Hkv, Dh), ("kv_heads", None)),
                     bv=_zeros((Hkv, Dh), ("kv_heads", None)))
    return {pre + name: sp for name, sp in specs.items()}


def _gelu_mlp_specs(cfg: ModelConfig) -> Specs:
    """``w_in`` (d, f), ``b_in`` (f,), ``w_out`` (f, d), ``b_out`` (d,):
    the biases start at zero."""
    d, f = cfg.d_model, cfg.d_ff
    return {"w_in": fan_in((d, f), ("d_model", "d_ff")),
            "b_in": _zeros(f, ("d_ff",)),
            "w_out": fan_in((f, d), ("d_ff", "d_model")),
            "b_out": _zeros(d)}


def _swiglu_specs(cfg: ModelConfig) -> Specs:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": fan_in((d, f), ("d_model", "d_ff")),
            "w_up": fan_in((d, f), ("d_model", "d_ff")),
            "w_down": fan_in((f, d), ("d_ff", "d_model"))}


class DenseBlock(_Block):
    @staticmethod
    def specs(cfg: ModelConfig) -> Specs:
        """``repro.models.blocks.init_blocks`` and ``attention.init_attn``."""
        d = cfg.d_model
        return {"ln1": _ones(d), "ln2": _ones(d), **_attn_specs(cfg),
                **_swiglu_specs(cfg)}


class MoEBlock(_Block):
    @staticmethod
    def specs(cfg: ModelConfig) -> Specs:
        """``repro.models.blocks.init_blocks`` for the moe family: the
        attention of ``DenseBlock`` and ``moe.init_moe``'s experts in place
        of its MLP."""
        d = cfg.d_model
        return {"ln1": _ones(d), "ln2": _ones(d),
                **_attn_specs(cfg), **moe.init_moe(cfg)}


class RWKVBlock(_Block):
    @staticmethod
    def specs(cfg: ModelConfig) -> Specs:
        """``repro.models.blocks.init_blocks`` (blocks.py:29-33) and
        ``rwkv.init_rwkv`` (rwkv.py:31-43): the time-mix anchors ``mu``,
        the decay base ``w0``, the bonus ``u`` and the channel-mix anchors
        ``mu_c`` start at zero."""
        d, f, H, Dh, R = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim,
                          rwkv.LORA_R)
        sq = ("d_model", "heads_flat")
        return {"ln1": _ones(d), "ln2": _ones(d),
                "mu": _zeros((5, d), (None, "d_model")), "w0": _zeros(d),
                "wa": fan_in((d, R), ("d_model", None)),
                "wb": fan_in((R, d), (None, "d_model")),
                "u": _zeros((H, Dh), ("heads", None)),
                "wr": fan_in((d, d), sq), "wk": fan_in((d, d), sq),
                "wv": fan_in((d, d), sq), "wg": fan_in((d, d), sq),
                "wo": fan_in((d, d), sq),
                "ln_x": _ones(d), "mu_c": _zeros((2, d), (None, "d_model")),
                "wk_c": fan_in((d, f), ("d_model", "d_ff")),
                "wv_c": fan_in((f, d), ("d_ff", "d_model")),
                "wr_c": fan_in((d, d), sq)}


class HybridBlock(_Block):
    @staticmethod
    def specs(cfg: ModelConfig) -> Specs:
        """``repro.models.blocks.init_blocks`` for the hybrid family
        (blocks.py:53-61): the attention of ``DenseBlock``, the norms
        ``ln_pa``/``ln_pm`` of its two branches, ``mamba.init_mamba``'s
        parameters and the shared SwiGLU."""
        d = cfg.d_model
        return {"ln1": _ones(d), "ln2": _ones(d), **_attn_specs(cfg),
                "ln_pa": _ones(d), "ln_pm": _ones(d),
                **mamba.init_mamba(cfg), **_swiglu_specs(cfg)}


class EncDecBlock(_Block):
    @staticmethod
    def specs(cfg: ModelConfig) -> Specs:
        """``repro.models.blocks.init_blocks`` for the encdec family
        (blocks.py:39-49): LayerNorm scales ``ln1``/``ln2``/``ln_x`` and
        biases ``lnb1``/``lnb2``/``lnb_x``, the self attention, the cross
        attention (``xwq`` ...) and the GELU MLP."""
        d = cfg.d_model
        return {"ln1": _ones(d), "ln2": _ones(d), **_attn_specs(cfg),
                "ln_x": _ones(d), "lnb1": _zeros(d), "lnb2": _zeros(d),
                "lnb_x": _zeros(d), **_attn_specs(cfg, "x"),
                **_gelu_mlp_specs(cfg)}


class EncoderBlock(_Block):
    @staticmethod
    def specs(cfg: ModelConfig) -> Specs:
        """``repro.models.blocks.init_encoder_blocks`` (blocks.py:64-78):
        bidirectional self attention and a GELU MLP, each after a
        LayerNorm."""
        d = cfg.d_model
        return {"ln1": _ones(d), "ln2": _ones(d), "lnb1": _zeros(d),
                "lnb2": _zeros(d), **_attn_specs(cfg),
                **_gelu_mlp_specs(cfg)}


BLOCKS = {"dense": DenseBlock, "vlm": DenseBlock, "moe": MoEBlock,
          "ssm": RWKVBlock, "hybrid": HybridBlock, "encdec": EncDecBlock}


def norm_fn(cfg: ModelConfig):
    """The RMSNorm of ``forward``: kernel K3 (``ops.rmsnorm``) on the
    kernel path (``attn_impl == "pallas"``), the plain norm otherwise.
    ``decode_step`` always takes the plain norm, as the JAX package's
    decode reaches no kernel."""
    return ops.rmsnorm if cfg.attn_impl == "pallas" else rmsnorm


def _res(x, y):
    """The residual add x + y.  Under a mesh (DTensors) its partial sums
    are reduced, d_model is gathered where it was sharded, and its
    gradient and the sublayer output's are held to their forward
    placements: the residual stream stays batch-sharded (the sequence
    sharded only under ``cfg.seq_shard_axis``), as GSPMD holds the
    cotangent of a sharded value; on plain tensors just x + y."""
    if not shd.is_dtensor(y):
        return x + y
    return shd.pin_grad(shd.gather_dim(
        shd.reduce_partial(x + shd.pin_grad(y)), -1))


def _seq_gathered(norm):
    """``norm``, whose output under a mesh has its sequence dim whole on
    every device (an all-gather where the residual stream is
    sequence-sharded, ``cfg.seq_shard_axis``: the Megatron schedule that
    GSPMD derives) and its gradient held to its placements; on plain
    tensors ``norm`` itself."""
    def f(x, scale, eps):
        y = norm(x, scale, eps)
        if not shd.is_dtensor(y):
            return y
        return shd.pin_grad(shd.gather_dim(y, 1))
    return f


def block_fwd(cfg: ModelConfig, window: int):
    """Returns f(block, x, positions, extra=None) -> (x, aux); ``extra``
    is the encdec layer's cross K/V ``(xk, xv)``."""
    eps = cfg.norm_eps
    norm = _seq_gathered(norm_fn(cfg))

    def no_aux(x):
        return torch.zeros((), dtype=torch.float32, device=x.device)

    def dense(p: DenseBlock, x, positions, extra=None):
        h = norm(x, p.ln1, eps)
        x = _res(x, attn.self_attention(p, h, cfg, positions, window))
        h = norm(x, p.ln2, eps)
        x = _res(x, swiglu(h, p.w_gate, p.w_up, p.w_down))
        return x, no_aux(x)

    def moe_blk(p: MoEBlock, x, positions, extra=None):
        h = norm(x, p.ln1, eps)
        x = _res(x, attn.self_attention(p, h, cfg, positions, window))
        h = norm(x, p.ln2, eps)
        y, aux = moe.moe_ffn(p, h, cfg)
        return _res(x, y), aux

    def ssm(p: RWKVBlock, x, positions, extra=None):
        B, _, d = x.shape
        zshift = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
        zstate = torch.zeros((B, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                             dtype=torch.float32, device=x.device)
        h = norm(x, p.ln1, eps)
        y, _, _ = rwkv.time_mix(p, h, cfg, zshift, zstate, cfg.attn_impl)
        x = _res(x, y)
        h = norm(x, p.ln2, eps)
        y, _ = rwkv.channel_mix(p, h, zshift)
        return _res(x, y), no_aux(x)

    def hybrid(p: HybridBlock, x, positions, extra=None):
        B = x.shape[0]
        di = mamba.d_inner(cfg)
        h = norm(x, p.ln1, eps)
        a = shd.pin_grad(attn.self_attention(p, h, cfg, positions, window))
        zconv = torch.zeros((B, mamba.CONV_K - 1, di), dtype=x.dtype,
                            device=x.device)
        zssm = torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                           device=x.device)
        m = shd.pin_grad(mamba.mamba_mix(p, h, cfg, zconv, zssm)[0])
        x = _res(x, 0.5 * (norm(a, p.ln_pa, eps) + norm(m, p.ln_pm, eps)))
        h = norm(x, p.ln2, eps)
        x = _res(x, swiglu(h, p.w_gate, p.w_up, p.w_down))
        return x, no_aux(x)

    def encdec(p: EncDecBlock, x, positions, extra=None):
        xk, xv = extra
        h = layernorm(x, p.ln1, p.lnb1, eps)
        x = _res(x, attn.self_attention(p, h, cfg, positions, 0))
        h = layernorm(x, p.ln_x, p.lnb_x, eps)
        x = _res(x, attn.cross_attention(p, h, xk, xv, cfg))
        h = layernorm(x, p.ln2, p.lnb2, eps)
        x = _res(x, gelu_mlp(h, p.w_in, p.b_in, p.w_out, p.b_out))
        return x, no_aux(x)

    return {"dense": dense, "vlm": dense, "moe": moe_blk, "ssm": ssm,
            "hybrid": hybrid, "encdec": encdec}[cfg.family]


def encoder_block_fwd(cfg: ModelConfig):
    """Returns f(block, x, positions) -> x for an ``EncoderBlock``: the
    self attention is bidirectional, so it never reaches K1."""
    eps = cfg.norm_eps

    def enc(p: EncoderBlock, x, positions):
        h = layernorm(x, p.ln1, p.lnb1, eps)
        x = _res(x, attn.self_attention(p, h, cfg, positions, 0,
                                        bidirectional=True))
        h = layernorm(x, p.ln2, p.lnb2, eps)
        return _res(x, gelu_mlp(h, p.w_in, p.b_in, p.w_out, p.b_out))

    return enc


def block_decode(cfg: ModelConfig, window: int, seq_sharded: bool):
    """Returns f(block, c, x, pos) -> x; ``c`` maps the names of the
    layer's cache entries to their slices, which are written in place
    (encdec's ``xk``/``xv`` are read only)."""
    eps = cfg.norm_eps

    def kv_attn(p, c, x, pos):
        h = rmsnorm(x, p.ln1, eps)
        out, _, _ = attn.decode_self_attention(
            p, h, cfg, c["k"], c["v"], pos, window, seq_sharded)
        return x + out

    def dense(p: DenseBlock, c, x, pos):
        x = kv_attn(p, c, x, pos)
        h = rmsnorm(x, p.ln2, eps)
        return x + swiglu(h, p.w_gate, p.w_up, p.w_down)

    def moe_blk(p: MoEBlock, c, x, pos):
        # the form ``moe_ffn`` picks at S = 1: grouped for qwen3-moe, whose
        # capacity(1) is top_k, so no slot drops while decoding
        x = kv_attn(p, c, x, pos)
        h = rmsnorm(x, p.ln2, eps)
        y, _ = moe.moe_ffn(p, h, cfg)
        return x + y

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

    def hybrid(p: HybridBlock, c, x, pos):
        h = rmsnorm(x, p.ln1, eps)
        a, _, _ = attn.decode_self_attention(
            p, h, cfg, c["k"], c["v"], pos, window, seq_sharded)
        m, conv, ssm_state = mamba.mamba_mix(p, h, cfg, c["conv"], c["ssm"])
        c["conv"].copy_(conv)
        c["ssm"].copy_(ssm_state)
        x = x + 0.5 * (rmsnorm(a, p.ln_pa, eps) + rmsnorm(m, p.ln_pm, eps))
        h = rmsnorm(x, p.ln2, eps)
        return x + swiglu(h, p.w_gate, p.w_up, p.w_down)

    def encdec(p: EncDecBlock, c, x, pos):
        h = layernorm(x, p.ln1, p.lnb1, eps)
        out, _, _ = attn.decode_self_attention(
            p, h, cfg, c["k"], c["v"], pos, 0, seq_sharded)
        x = x + out
        h = layernorm(x, p.ln_x, p.lnb_x, eps)
        x = x + attn.cross_attention(p, h, c["xk"], c["xv"], cfg)
        h = layernorm(x, p.ln2, p.lnb2, eps)
        return x + gelu_mlp(h, p.w_in, p.b_in, p.w_out, p.b_out)

    return {"dense": dense, "vlm": dense, "moe": moe_blk, "ssm": ssm,
            "hybrid": hybrid, "encdec": encdec}[cfg.family]

"""Selective SSM (Mamba) path of the Hymba hybrid blocks.

Diagonal selective scan:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

The counterpart of ``repro.models.mamba``, with the same dtype flow: the
projections and the causal conv in the working type, the SiLU gates, the
step ``dt``, ``B``, ``C`` and the scan in float32.  ``p`` is a layer's
``HybridBlock``, whose parameters keep the JAX package's names and
per-layer shapes.  The JAX package scans with ``jax.lax.associative_scan``
(plain JAX, no TPU kernel); here the same ``(a, b)`` combine runs as a
log-step (Hillis-Steele) scan over time: ceil(log2 S) whole-tensor steps,
on the card as on the CPU, and on both model paths.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Specs, fan_in, spec

CONV_K = 4  # depthwise causal conv kernel size


def d_inner(cfg: ModelConfig) -> int:
    return 2 * cfg.d_model


def init_mamba(cfg: ModelConfig) -> Specs:
    """One layer's mamba parameters (``repro.models.mamba.init_mamba``):
    ``m_in`` (d, 2 Di), ``m_conv`` (K, Di), ``m_xbc`` (Di, 2N + 1) and
    ``m_out`` (Di, d) drawn with std 1/sqrt(shape[-2]); ``m_alog`` and
    ``m_dtb`` (Di,) zeros, ``m_d`` (Di,) ones."""
    d, n, di = cfg.d_model, cfg.ssm_state, d_inner(cfg)
    f = ("d_ff",)
    return {"m_in": fan_in((d, 2 * di), ("d_model", "d_ff")),
            "m_conv": fan_in((CONV_K, di), (None, "d_ff")),
            "m_xbc": fan_in((di, 2 * n + 1), ("d_ff", None)),
            "m_alog": spec((di,), "zeros", f), "m_dtb": spec((di,), "zeros", f),
            "m_d": spec((di,), "ones", f),
            "m_out": fan_in((di, d), ("d_ff", "d_model"))}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, conv_state: torch.Tensor):
    """Depthwise causal conv.  x: (B,S,Di); w: (K,Di); conv_state:
    (B,K-1,Di) = trailing inputs of the previous segment.  The taps are
    summed left to right in the working type, as the reference does (not
    ``F.conv1d``, which accumulates in float32)."""
    S = x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = xp[:, :S] * w[0]
    for i in range(1, w.shape[0]):
        out = out + xp[:, i:i + S] * w[i]
    return out, xp[:, -(w.shape[0] - 1):]


def _ssm_scan(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t * h_{t-1} + bx_t over dim 1.  a: (B,S,Di,1) (the decay
    is the same for every state channel); bx: (B,S,Di,N), overwritten
    with h, unless autograd records the scan or the tensors are DTensors
    (then each step is a new tensor, with the same sums); h0: (B,Di,N).  Returns (h, h[:, -1]).

    h0 is folded into the first element, then step d (1, 2, 4, ...)
    combines each element t >= d with element t - d by the reference's
    ``combine(l, r) = (a_l a_r, a_r b_l + b_r)``; at S = 1 (decode) no
    step runs."""
    taped = (torch.is_grad_enabled() and (a.requires_grad or bx.requires_grad)
             or shd.is_dtensor(bx))
    if taped:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], 1)
    else:
        bx[:, 0] += a[:, 0] * h0
    S, d = a.shape[1], 1
    while d < S:
        if taped:
            bx = torch.cat([bx[:, :d], bx[:, d:] + a[:, d:] * bx[:, :-d]], 1)
        else:
            bx[:, d:] += a[:, d:] * bx[:, :-d]
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return bx, bx[:, -1]


def mamba_mix(p, x: torch.Tensor, cfg: ModelConfig,
              conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """x: (B,S,D).  Returns (out, new_conv_state in the working type,
    new_ssm_state float32)."""
    n = cfg.ssm_state
    xin, gate = (x @ p.m_in).chunk(2, dim=-1)                 # (B,S,Di) each
    xc, new_conv = _causal_conv(xin, p.m_conv, conv_state)
    xc = F.silu(xc.float())
    # under a mesh the product is a partial sum over the sharded inner
    # width; reduce it here, before the slices meet d_ff-sharded biases
    xbc = shd.reduce_partial(xc.to(x.dtype) @ p.m_xbc)
    B_, C_, dt = xbc[..., :n], xbc[..., n:2 * n], xbc[..., 2 * n].float()
    # dt: scalar per token, broadcast per channel with a learned bias
    dt = F.softplus(dt[..., None] + p.m_dtb.float())          # (B,S,Di)
    A = -torch.exp(p.m_alog.float())                          # (Di,)
    a = torch.exp(dt * A)[..., None]                          # (B,S,Di,1)
    bx = (dt * xc)[..., None] * B_.float()[:, :, None, :]     # (B,S,Di,N)
    h, new_ssm = _ssm_scan(a, bx, ssm_state.float())
    y = torch.einsum("bsen,bsn->bse", h, C_.float())
    y = y + p.m_d.float() * xc
    y = y.to(x.dtype) * F.silu(gate.float()).to(x.dtype)
    return y @ p.m_out, new_conv, new_ssm

"""Shared layers: RMSNorm, LayerNorm, SwiGLU, the GELU MLP and rotary
position embeddings.

The dtype flow is ``repro.models.layers``': normalisation, the SiLU and
GELU gates and RoPE compute in float32 and cast back to the working type;
the matrix products and the MLP biases run in the working type.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

# The plain RMSNorm (float32 math, cast back): the plain version of kernel
# K3, which the kernel path of ``forward`` takes instead (blocks.norm_fn).
from repro_torch.kernels.ref import rmsnorm_ref as rmsnorm  # noqa: F401

# How ``model.init_params`` fills a parameter: "ones", "zeros", or the std
# of a normal draw.
Init = Union[str, float]
Axes = Tuple[Optional[str], ...]


class Spec(NamedTuple):
    """One parameter: its per-layer shape, how it is filled, and its
    logical axes, one name (or None) per dim, as the JAX ``ParamFactory``
    names them without the stacked ``"layer"`` axis
    (``repro_torch.models.sharding`` maps them to a mesh)."""
    shape: Tuple[int, ...]
    init: Init
    axes: Axes


Specs = Dict[str, Spec]


def fan_in(shape: Tuple[int, ...], axes: Axes) -> Spec:
    """A normal draw of std 1/sqrt(shape[-2]): the JAX ``ParamFactory``
    default, whose stacked shapes have the same second-to-last dim."""
    return spec(shape, 1.0 / math.sqrt(max(1, shape[-2])), axes)


def spec(shape: Tuple[int, ...], init: Init, axes: Axes) -> Spec:
    shape = tuple(int(s) for s in shape)
    assert len(shape) == len(axes), (shape, axes)
    return Spec(shape, init, tuple(axes))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 with the population variance (``jnp.var``),
    cast back; no TPU kernel computes it, so both paths take this."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation."""
    h = x @ w_in + b_in
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ w_out + b_out


def rope_freqs(head_dim: int, theta: float,
               device: torch.device = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S).  Split-halves rotation in
    float32."""
    if theta <= 0:
        return x
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (Dh/2,)
    ang = positions[..., :, None].float() * freqs           # (...,S,Dh/2)
    cos = torch.cos(ang)[..., :, None, :]                   # (...,S,1,Dh/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)

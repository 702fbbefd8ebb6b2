"""Shared layers: RMSNorm, SwiGLU and rotary position embeddings.

The dtype flow is ``repro.models.layers``': normalisation, the SiLU gate and
RoPE compute in float32 and cast back to the working type; the matrix
products run in the working type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# The plain RMSNorm (float32 math, cast back): the plain version of kernel
# K3, which the kernel path of ``forward`` takes instead (blocks.norm_fn).
from repro_torch.kernels.ref import rmsnorm_ref as rmsnorm  # noqa: F401


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


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

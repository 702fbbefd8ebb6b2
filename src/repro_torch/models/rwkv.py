"""RWKV6 ("Finch") — data-dependent decay linear-attention block.

Recurrence (per head, K = V = head_dim):
    S_t = diag(w_t) @ S_{t-1} + k_t^T v_t          (state: K x V)
    o_t = r_t @ (diag(u) k_t^T v_t + S_{t-1})
with w_t in (0,1) produced by a LoRA on the shifted input.

The counterpart of ``repro.models.rwkv``, with the same dtype flow: the
products run in the working type, the decay, the gates and the group norm
in float32, and the decay ``w`` stays float32 into the scan.  ``p`` is a
layer's ``RWKVBlock``, whose parameters keep the JAX package's names and
per-layer shapes.  With ``impl="pallas"`` the prefill scan goes through
``kernels.ops.rwkv6_scan`` (the hand-written Hopper kernel on a CUDA
tensor); ``wkv_scan`` is the model's own plain scan, which the decode step
always takes, one token at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models.config import ModelConfig

LORA_R = 64


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D); prev: (B,1,D) last token of previous segment."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in (0,1), float32.  xw: (B,S,D)."""
    lora = xw @ p.wa
    lora = torch.tanh(lora.float()) @ p.wb.float()
    logw = p.w0.float() + lora
    return torch.exp(-torch.exp(logw))


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def wkv_scan(r, k, v, w, u, state):
    """Plain WKV6 scan.  r,k,v: (B,S,H,Dh); w: (B,S,H,Dh) decay;
    u: (H,Dh); state: (B,H,Dh,Dh).  Returns (out (B,S,H,Dh), new_state).
    The sequential recurrence of ``kernels.ref.rwkv6_scan_ref``, on
    (B,H,S,Dh) views."""
    rt, kt, vt, wt = (t.transpose(1, 2) for t in (r, k, v, w))
    out, s = ref.rwkv6_scan_ref(rt, kt, vt, wt, u, state)
    return out.transpose(1, 2), s


def _heads(x: torch.Tensor, H: int, Dh: int) -> torch.Tensor:
    return x.unflatten(-1, (H, Dh))


def _groupnorm(x: torch.Tensor, scale: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Per-head normalization of (B,S,H,Dh) then flatten."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, correction=0, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out.flatten(-2) * scale.float()
    return out.to(x.dtype)


def time_mix_inputs(p, x: torch.Tensor, cfg: ModelConfig,
                    shift_prev: torch.Tensor):
    """The scan's inputs r, k, v (B,S,H,Dh) in the working type, the
    float32 decay w (B,S,H,Dh), and the output gate g (B,S,d)."""
    H, Dh = cfg.n_heads, cfg.head_dim
    xs = _token_shift(x, shift_prev)
    mu = p.mu
    xr = _mix(x, xs, mu[0])
    xk = _mix(x, xs, mu[1])
    xv = _mix(x, xs, mu[2])
    xw = _mix(x, xs, mu[3])
    xg = _mix(x, xs, mu[4])
    r = _heads(xr @ p.wr, H, Dh)
    k = _heads(xk @ p.wk, H, Dh)
    v = _heads(xv @ p.wv, H, Dh)
    g = F.silu((xg @ p.wg).float()).to(x.dtype)
    w = _heads(_decay(p, xw), H, Dh)
    return r, k, v, w, g


def time_mix(p, x: torch.Tensor, cfg: ModelConfig, shift_prev: torch.Tensor,
             state: torch.Tensor, impl: str = "xla"):
    """Full time-mix block.  Returns (out, last_token, new_state)."""
    r, k, v, w, g = time_mix_inputs(p, x, cfg, shift_prev)
    if impl == "pallas":
        out, new_state = kops.rwkv6_scan(r, k, v, w, p.u, state)
    else:
        out, new_state = wkv_scan(r, k, v, w, p.u, state)
    out = _groupnorm(out, p.ln_x, cfg.norm_eps) * g
    return out @ p.wo, x[:, -1:], new_state


def channel_mix(p, x: torch.Tensor, shift_prev: torch.Tensor):
    xs = _token_shift(x, shift_prev)
    xk = _mix(x, xs, p.mu_c[0])
    xr = _mix(x, xs, p.mu_c[1])
    k = xk @ p.wk_c
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = k @ p.wv_c
    rgate = torch.sigmoid((xr @ p.wr_c).float()).to(x.dtype)
    return rgate * kv, x[:, -1:]

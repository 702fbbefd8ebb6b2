"""Plain PyTorch versions of the hand-written kernels (the allclose targets).

They run on any device.  The wrappers in ``ops`` take them for tensors that
lie on the CPU; ``chip_smoke.py`` holds each kernel against them on the
card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,Hq,S,D); k,v: (B,Hkv,S,D) -> (B,Hq,S,D).  GQA by head
    grouping; optional causal + sliding-window masking; f32 math."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, S, D).float()
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) / math.sqrt(D)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= kj > qi - window
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vf)
    return out.reshape(B, Hq, S, D).to(q.dtype)


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """r,k,v,w: (B,H,S,D); u: (H,D); state: (B,H,D,D).
    WKV6: S_t = diag(w_t) S_{t-1} + k_t^T v_t; o_t = r_t (diag(u)k_t^T v_t
    + S_{t-1}), sequentially in float32.  Returns (out (B,H,S,D) in r's
    dtype, new_state (B,H,D,D) float32)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = state.float()
    outs = []
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]   # (B,H,D,D)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], uf * kv + s))
        s = wf[:, :, t, :, None] * s + kv
    return torch.stack(outs, 2).to(r.dtype), s

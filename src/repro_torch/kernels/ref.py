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

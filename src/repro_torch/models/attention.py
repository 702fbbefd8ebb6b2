"""GQA attention: causal / sliding-window prefill and the decode path.

The einsum path (``cfg.attn_impl == "xla"``) is the plain version; with
``"pallas"`` the prefill goes through ``kernels.ops.flash_attention``,
which launches the hand-written Hopper kernel on a CUDA tensor.  ``p`` is
a layer's ``DenseBlock``: its parameters keep the JAX package's names and
layouts (``wq`` (d, Hq, Dh), ``wk``/``wv`` (d, Hkv, Dh), ``wo`` (Hq, Dh, d)).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,d) @ (d,H,Dh) -> (B,S,H,Dh)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def qkv(p, x: torch.Tensor):
    return _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B,S,Hq,Dh) @ (Hq,Dh,d) -> (B,S,d).  The flatten is a view when
    ``out`` is contiguous, as the kernel path's output is."""
    return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,Hq,D), k: (B,Sk,Hkv,D) -> scores (B,Hkv,G,Sq,Sk), in the
    working type (the caller moves them to float32)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    scale = torch.tensor(math.sqrt(D), dtype=q.dtype, device=q.device)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / scale


def _grouped_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,Hkv,G,Sq,Sk), v: (B,Sk,Hkv,D) -> (B,Sq,Hq,D)."""
    B, Hkv, G, Sq, Sk = probs.shape
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hkv * G, out.shape[-1])


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax attention with GQA grouping.  mask: (Sq,Sk) or
    broadcastable to (B,1,1,Sq,Sk); True = attend."""
    scores = _grouped_scores(q, k).float().masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _grouped_out(probs, v)


def causal_mask(sq: int, sk: int, window: int = 0,
                device: torch.device = None) -> torch.Tensor:
    """(sq, sk) boolean mask; True = attend."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= kj > (qi - window)
    return m


def self_attention(p, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Causal prefill self-attention over the full sequence."""
    q, k, v = qkv(p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.attn_impl == "pallas":
        out = kops.flash_attention(q, k, v, causal=True, window=window)
    else:
        S = x.shape[1]
        out = attend(q, k, v, causal_mask(S, S, window, device=x.device))
    return _out_proj(out, p.wo)


# ---------------------------------------------------------------------------
# Decode path (one new token against a KV cache)
# ---------------------------------------------------------------------------

def update_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k1: torch.Tensor, v1: torch.Tensor, pos: int,
                 seq_sharded: bool):
    """Write the new token's K/V (B,1,Hkv,Dh) into the cache (B,S,Hkv,Dh)
    at ``pos``, IN PLACE, and return the two cache tensors.

    The JAX package returns new arrays (``dynamic_update_slice``, or an
    iota/select write when the sequence dim is sharded); here the cache
    is updated where it lies, which saves a copy of the whole cache per
    token.  Both branches are kept and write the same values.
    """
    if seq_sharded:
        idx = torch.arange(cache_k.shape[1], device=cache_k.device)
        sel = idx[None, :, None, None] == pos
        cache_k.copy_(torch.where(sel, k1.to(cache_k.dtype), cache_k))
        cache_v.copy_(torch.where(sel, v1.to(cache_v.dtype), cache_v))
    else:
        cache_k[:, pos:pos + 1] = k1.to(cache_k.dtype)
        cache_v[:, pos:pos + 1] = v1.to(cache_v.dtype)
    return cache_k, cache_v


def decode_self_attention(p, x: torch.Tensor, cfg: ModelConfig,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          pos: int, window: int = 0,
                          seq_sharded: bool = False):
    """x: (B,1,D); cache: (B,S,Hkv,Dh), updated in place.  Returns (out,
    cache_k, cache_v)."""
    q, k1, v1 = qkv(p, x)
    posv = torch.full((1, 1), pos, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k1 = apply_rope(k1, posv, cfg.rope_theta)
    new_k, new_v = update_cache(cache_k, cache_v, k1, v1, pos, seq_sharded)
    S = cache_k.shape[1]
    kj = torch.arange(S, device=x.device)[None, :]
    mask = kj <= pos
    if window > 0:
        mask &= kj > (pos - window)
    out = attend(q, new_k.to(q.dtype), new_v.to(q.dtype),
                 mask[:, None, :])  # fp8 caches upcast on read
    return _out_proj(out, p.wo), new_k, new_v

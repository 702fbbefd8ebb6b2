"""GQA attention: causal / sliding-window / bidirectional prefill, the
decoder's cross attention and the decode path.

The einsum path (``cfg.attn_impl == "xla"``) is the plain version; with
``"pallas"`` the causal prefill goes through ``kernels.ops.flash_attention``,
which launches the hand-written Hopper kernel on a CUDA tensor.  The
bidirectional (encoder) self attention and the cross attention take the
einsum path on both, as in the JAX package.  ``p`` is a layer's block:
its parameters keep the JAX package's names and layouts (``wq`` (d, Hq,
Dh), ``wk``/``wv`` (d, Hkv, Dh), ``wo`` (Hq, Dh, d), and with
``cfg.qkv_bias`` ``bq`` (Hq, Dh), ``bk``/``bv`` (Hkv, Dh)); the cross
attention's carry the prefix ``x`` (``xwq`` ... ``xwo``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,d) @ (d,H,Dh) -> (B,S,H,Dh)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def qkv(p, x: torch.Tensor, cfg: ModelConfig, pre: str = ""):
    q, k, v = (_proj(x, getattr(p, pre + name))
               for name in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = (t + getattr(p, pre + name)
                   for t, name in ((q, "bq"), (k, "bk"), (v, "bv")))
    return q, k, v


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
           mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked softmax attention with GQA grouping.  mask: (Sq,Sk) or
    broadcastable to (B,1,1,Sq,Sk); True = attend; None = attend to
    every key.  On DTensors (a mesh) it runs as ``_mesh_attend``."""
    if shd.is_dtensor(q):
        return _mesh_attend(q, k, v, mask)
    scores = _grouped_scores(q, k).float()
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _grouped_out(probs, v)


def _mesh_attend(q, k, v, mask):
    """``attend`` on DTensors, each device on its shard: the batch stays
    sharded where q's or k's is; the heads shard over ``model`` where the
    query heads divide it (K/V with them where the KV heads divide it,
    else the replicated K/V are expanded to the query heads first, a local
    view); a decode step (one query) keeps the cache's sequence shards and
    merges the softmax across them with explicit all-reduces (max, then
    sums).  Any other sharding is gathered first.  Every move is an
    explicit ``redistribute`` or collective, so the dry run records it."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qp, kp, op, key_dims = [], [], [], []
    expand = False
    for i, name in enumerate(mesh.mesh_dim_names):
        size = mesh.size(i)
        if Sq == 1 and k.placements[i] == Shard(1):
            qp.append(Replicate()), kp.append(Shard(1))
            op.append(Replicate()), key_dims.append(i)
        elif Shard(0) in (q.placements[i], k.placements[i]):
            qp.append(Shard(0)), kp.append(Shard(0)), op.append(Shard(0))
        elif name == "model" and Hq % size == 0:
            expand = Hkv % size != 0
            qp.append(Shard(2)), kp.append(Replicate() if expand else Shard(2))
            op.append(Shard(2))
        else:
            qp.append(Replicate()), kp.append(Replicate())
            op.append(Replicate())
    q = q.redistribute(mesh, qp)
    k, v = (t.redistribute(mesh, kp) for t in (k, v))
    if expand:
        G = Hq // Hkv
        k, v = (t.unsqueeze(3).expand(B, t.shape[1], Hkv, G, D)
                .reshape(B, t.shape[1], Hq, D) for t in (k, v))
        kp = [Shard(2) if p == Shard(2) else kp[j] for j, p in enumerate(qp)]
        k, v = (t.redistribute(mesh, kp) for t in (k, v))

    def local(ql, kl, vl):
        if not key_dims:
            return attend(ql, kl, vl, mask)
        m = mask
        if m is not None:
            off = shd.shard_offset(mesh, kp, 1, kl.shape[1])
            m = m[..., off:off + kl.shape[1]]
        scores = _grouped_scores(ql, kl).float()
        if m is not None:
            scores = scores.masked_fill(~m, NEG_INF)
        group = [(mesh, i) for i in key_dims]
        mx = scores.amax(dim=-1, keepdim=True)
        for g in group:
            mx = funcol.all_reduce(mx, "max", g)
        e = torch.exp(scores - mx)
        den = e.sum(dim=-1, keepdim=True)
        for g in group:
            den = funcol.all_reduce(den, "sum", g)
        out = _grouped_out((e / den).to(ql.dtype), vl)
        for g in group:
            out = funcol.all_reduce(out, "sum", g)
        return out

    return shd.local_map(local, out_placements=op,
                     in_placements=(q.placements, k.placements,
                                    v.placements),
                     device_mesh=mesh)(q, k, v)


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
                   positions: torch.Tensor, window: int = 0,
                   bidirectional: bool = False,
                   pre: str = "") -> torch.Tensor:
    """Prefill self-attention over the full sequence: causal (K1 on the
    kernel path), or with ``bidirectional`` unmasked and always the
    einsum path (the encoder's)."""
    q, k, v = qkv(p, x, cfg, pre)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if bidirectional:
        out = attend(q, k, v, None)
    elif cfg.attn_impl == "pallas":
        out = kops.flash_attention(q, k, v, causal=True, window=window)
    else:
        S = x.shape[1]
        out = attend(q, k, v, causal_mask(S, S, window, device=x.device))
    return _out_proj(out, getattr(p, pre + "wo"))


def cross_attention(p, x: torch.Tensor, kv_k: torch.Tensor,
                    kv_v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V
    (B, enc_seq, Hkv, Dh), cast to q's dtype; no mask."""
    q = _proj(x, p.xwq)
    out = attend(q, kv_k.to(q.dtype), kv_v.to(q.dtype), None)
    return _out_proj(out, p.xwo)


def encoder_kv(p, enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross attention's K/V (B, enc_seq, Hkv, Dh) of the encoder's
    output (B, enc_seq, d)."""
    return _proj(enc, p.xwk), _proj(enc, p.xwv)


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
    q, k1, v1 = qkv(p, x, cfg)
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

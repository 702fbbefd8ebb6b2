"""Top-k token-choice MoE with capacity: scatter dispatch, gather combine.

The counterpart of ``repro.models.moe``, with the same names and the same
arithmetic: routing in float32 from a router product in the working
type, slot-major positions (slot ``s*K + k``) from a cumulative count per
expert, a token's slot kept while its position is below the capacity
``C``, dropped slots clipped to ``C - 1`` and added there as zero rows
(a scatter-add, never an assignment, so a dropped slot cannot overwrite
the kept token that holds the same place).

The JAX package pins the dispatch buffer to a mesh with
``with_sharding_constraint`` (moe.py:168-180); one card has no mesh, so
those calls are dropped, and ``cfg.moe_expert_axis`` and
``cfg.batch_shard_axes`` are carried but not read.  The buffers here are
expert-major, (E, C, D) and (E, B, C, D), so that each expert product is
one batched matrix product over the experts with no transpose; the values
are the reference's (B, E, C, D) buffer's.

The experts carry no TPU kernel in the JAX package: dispatch, the expert
products and the combine are plain array operations there, and plain
PyTorch operations here.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Specs, fan_in


def init_moe(cfg: ModelConfig) -> Specs:
    """One layer's MoE parameters (``repro.models.moe.init_moe``: the
    router (d, E), ``we_gate``/``we_up`` (E, d, f), ``we_down`` (E, f, d)),
    each a draw of std 1/sqrt(shape[-2]) as the stacked JAX shape gives."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": fan_in(d, E), "we_gate": fan_in(E, d, f),
            "we_up": fan_in(E, d, f), "we_down": fan_in(E, f, d)}


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(cfg.top_k, min(n_tokens, (c + 3) // 4 * 4))


def route(logits: torch.Tensor, cfg: ModelConfig):
    """logits: (N, E) -> (weights (N,K) float32, idx (N,K), aux_loss
    float32 scalar)."""
    probs = torch.softmax(logits.float(), dim=-1)
    topw, topi = torch.topk(probs, cfg.top_k, dim=-1)   # descending
    topw = topw / topw.sum(dim=-1, keepdim=True)
    # Switch-style load-balance loss: E * mean_e(frac_tokens_e * mean_prob_e)
    E = cfg.n_experts
    frac = F.one_hot(topi[:, 0], E).float().mean(dim=0)
    mprob = probs.mean(dim=0)
    aux = E * torch.sum(frac * mprob)
    return topw, topi, aux


# Below this expert count the dense form runs (few, fat experts: grok-1's
# 8 x 32768), from it on the grouped form (many small experts: qwen3's
# 128 x 1536): the JAX package's choice, copied.
GROUPED_MIN_EXPERTS = 32


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE FFN; the dispatch form chosen by expert count, as in the
    JAX package.  ``p`` holds the layer's ``router``, ``we_gate``,
    ``we_up`` and ``we_down``.  Returns (out, aux * router_aux_weight)."""
    if cfg.n_experts < GROUPED_MIN_EXPERTS:
        return moe_ffn_dense(p, x, cfg)
    return moe_ffn_grouped(p, x, cfg)


def _expert(h: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU's gate in float32, cast back, times the up projection, then
    the down projection (batched over a leading expert dim when the
    weights have one)."""
    return torch.matmul(F.silu(g.float()).to(h.dtype) * u, w_down)


def moe_ffn_dense(p, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert on every token, weighted by a gate matrix that holds
    the renormalised top-k weights and 0 elsewhere: no dispatch buffer.
    The gates are cast to the working type and the experts accumulate in
    it from e = 0, as the reference's scan does."""
    B, S, D = x.shape
    N, E = B * S, cfg.n_experts
    logits = x @ p.router
    topw, topi, aux = route(logits.reshape(N, E), cfg)
    gates = torch.zeros((N, E), dtype=torch.float32, device=x.device)
    gates = gates.scatter_(1, topi, topw).reshape(B, S, E).to(x.dtype)
    acc = torch.zeros_like(x)
    for e in range(E):
        y = _expert(x, x @ p.we_gate[e], x @ p.we_up[e], p.we_down[e])
        acc = acc + gates[..., e, None] * y
    return acc, aux * cfg.router_aux_weight


def _positions(e_idx: torch.Tensor, E: int, C: int):
    """Each slot's place in its expert's queue, counted along the last
    dim of ``e_idx`` (slot order): (keep, the place clipped to C - 1)."""
    counts = torch.cumsum(F.one_hot(e_idx, E), dim=-2)    # (..., slots, E)
    pos = counts.gather(-1, e_idx[..., None])[..., 0] - 1
    keep = (pos >= 0) & (pos < C)
    return keep, pos.clamp(0, C - 1)


def moe_ffn_flat(p, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (E, C, D) buffer over all N = B*S tokens, C = capacity(N)."""
    B, S, D = x.shape
    N, E, K = B * S, cfg.n_experts, cfg.top_k
    C = capacity(N, cfg)
    xf = x.reshape(N, D)
    topw, topi, aux = route(xf @ p.router, cfg)

    e_idx = topi.reshape(N * K)
    keep, posc = _positions(e_idx, E, C)
    xrep = xf.repeat_interleave(K, dim=0)
    contrib = torch.where(keep[:, None], xrep, torch.zeros_like(xrep))
    buf = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((e_idx, posc), contrib, accumulate=True)

    yb = _expert(buf, torch.bmm(buf, p.we_gate), torch.bmm(buf, p.we_up),
                 p.we_down)                                     # (E, C, D)
    yt = yb[e_idx, posc]
    w = (topw.reshape(N * K) * keep).to(x.dtype)
    out = (yt * w[:, None]).reshape(N, K, D).sum(dim=1)
    return out.reshape(B, S, D), aux * cfg.router_aux_weight


def moe_ffn_grouped(p, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions counted per batch row over its S*K slots, C = capacity(S)
    per row, one (E, B, C, D) buffer."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(S, cfg)                       # per-row capacity
    logits = x @ p.router
    topw, topi, aux = route(logits.reshape(B * S, E), cfg)

    # slot-major within each row: (B, S, K) -> (B, S*K)
    e_idx = topi.reshape(B, S * K)
    keep, posc = _positions(e_idx, E, C)
    xrep = x.repeat_interleave(K, dim=1)                        # (B, SK, D)
    contrib = torch.where(keep[..., None], xrep, torch.zeros_like(xrep))
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    buf = torch.zeros((E, B, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((e_idx, b_idx, posc), contrib, accumulate=True)

    flat = buf.view(E, B * C, D)
    yb = _expert(flat, torch.bmm(flat, p.we_gate), torch.bmm(flat, p.we_up),
                 p.we_down).view(E, B, C, D)
    yt = yb[e_idx, b_idx, posc]                                 # (B, SK, D)
    w = (topw.reshape(B, S * K) * keep).to(x.dtype)
    out = (yt * w[..., None]).reshape(B, S, K, D).sum(dim=2)
    return out, aux * cfg.router_aux_weight

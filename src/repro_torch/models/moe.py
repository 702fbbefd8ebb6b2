"""Top-k token-choice MoE with capacity: scatter dispatch, gather combine.

The counterpart of ``repro.models.moe``, with the same names and the same
arithmetic: routing in float32 from a router product in the working
type, slot-major positions (slot ``s*K + k``) from a cumulative count per
expert, a token's slot kept while its position is below the capacity
``C``, dropped slots clipped to ``C - 1`` and added there as zero rows
(a scatter-add, never an assignment, so a dropped slot cannot overwrite
the kept token that holds the same place).

The buffers here are expert-major, (E, C, D) and (E, B, C, D), so that
each expert product is one batched matrix product over the experts with
no transpose; the values are the reference's (B, E, C, D) buffer's.

On DTensors (a mesh, the dry run) the scatters and gathers run on each
device's shard (``local_map``): the grouped form's dispatch fills each
device's rows of the buffer, the combine gathers from the device's
experts and leaves a partial sum over the experts' mesh axis, which the
residual add reduces.  With ``cfg.moe_expert_axis`` the buffer and the
expert outputs are pinned as the JAX package pins them (moe.py:168-185):
experts (dim 0 here) over that axis, the batch (dim 1) over
``cfg.batch_shard_axes``.  On plain tensors these fields change nothing.

The experts carry no TPU kernel in the JAX package: dispatch, the expert
products and the combine are plain array operations there, and plain
PyTorch operations here.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Specs, fan_in


def init_moe(cfg: ModelConfig) -> Specs:
    """One layer's MoE parameters (``repro.models.moe.init_moe``: the
    router (d, E), ``we_gate``/``we_up`` (E, d, f), ``we_down`` (E, f, d)),
    each a draw of std 1/sqrt(shape[-2]) as the stacked JAX shape gives."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    edf = ("experts", "d_model", "d_ff")
    return {"router": fan_in((d, E), ("d_model", None)),
            "we_gate": fan_in((E, d, f), edf), "we_up": fan_in((E, d, f), edf),
            "we_down": fan_in((E, f, d), ("experts", "d_ff", "d_model"))}


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
    gates = shd.rowwise(_gates, topw, topi, E).reshape(B, S, E).to(x.dtype)
    acc = torch.zeros_like(x)
    for e in range(E):
        y = _expert(x, x @ p.we_gate[e], x @ p.we_up[e], p.we_down[e])
        acc = acc + gates[..., e, None] * y
    return acc, aux * cfg.router_aux_weight


def _gates(topw: torch.Tensor, topi: torch.Tensor, E: int) -> torch.Tensor:
    """(N, E) float32: topw at topi, 0 elsewhere."""
    gates = torch.zeros((topw.shape[0], E), dtype=torch.float32,
                        device=topw.device)
    return gates.scatter_(1, topi, topw)


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
    if shd.is_dtensor(x):
        # one buffer over every token: its positions count across the
        # batch, so each device takes the whole batch (an explicit gather)
        from torch.distributed.tensor import Replicate
        x = x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
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
    if shd.is_dtensor(contrib):
        buf = buf.index_put((e_idx, posc), contrib, accumulate=True)
    else:
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
    buf = _dispatch(x, e_idx, keep, posc, E, C)            # (E, B, C, D)
    buf = _pin(buf, cfg)
    flat = buf.view(E, -1, D)
    yb = _expert(flat, torch.bmm(flat, p.we_gate), torch.bmm(flat, p.we_up),
                 p.we_down).view(E, -1, C, D)
    yb = _pin(yb, cfg)
    w = (topw.reshape(B, S * K) * keep).to(x.dtype)
    out = _combine(yb, e_idx, posc, w).reshape(B, S, K, D).sum(dim=2)
    return out, aux * cfg.router_aux_weight


def _pin(buf, cfg: ModelConfig):
    """The JAX package's buffer pins (moe.py:168-185), with
    ``cfg.moe_expert_axis`` and on DTensors only: experts (dim 0) over
    that axis, the batch (dim 1) over ``cfg.batch_shard_axes``."""
    if not (cfg.moe_expert_axis and shd.is_dtensor(buf)):
        return buf
    dims = {0: cfg.moe_expert_axis}
    if cfg.batch_shard_axes:
        dims[1] = tuple(cfg.batch_shard_axes)
    return shd.pin(buf, dims)


def _dispatch_rows(x, e_idx, keep, posc, E: int, C: int):
    B, SK = e_idx.shape
    K = SK // x.shape[1]
    xrep = x.repeat_interleave(K, dim=1)                        # (B, SK, D)
    contrib = torch.where(keep[..., None], xrep, torch.zeros_like(xrep))
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, SK)
    buf = torch.zeros((E, B, C, x.shape[2]), dtype=x.dtype, device=x.device)
    buf.index_put_((e_idx, b_idx, posc), contrib, accumulate=True)
    return buf


def _dispatch(x, e_idx, keep, posc, E: int, C: int):
    """The grouped buffer (E, B, C, D) of the kept slots, scatter-added.
    On DTensors each device fills the buffer of its batch rows (the
    scatter is row-local), which comes out sharded on dim 1 as x's batch
    is on dim 0."""
    if not shd.is_dtensor(x):
        return _dispatch_rows(x, e_idx, keep, posc, E, C)
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    pl = shd.row_placements(x)
    out = [Shard(1) if p == Shard(0) else p for p in pl]
    ins = [t.redistribute(mesh, pl) for t in (x, e_idx, keep, posc)]
    return shd.local_map(_dispatch_rows, out_placements=out,
                     in_placements=(pl, pl, pl, pl, None, None),
                     device_mesh=mesh)(*ins, E, C)


def _combine_rows(yb, e_idx, posc, w, e_off: int = 0):
    """sum over a slot's experts of w * yb[e, b, pos]; with ``e_off``,
    yb holds experts e_off .. e_off + E_local - 1 only and the others
    add 0 (a partial sum)."""
    B, SK = e_idx.shape
    b_idx = torch.arange(B, device=yb.device)[:, None].expand(B, SK)
    El = yb.shape[0]
    el = e_idx - e_off
    mine = (el >= 0) & (el < El)
    yt = yb[el.clamp(0, El - 1), b_idx, posc]
    w = torch.where(mine, w, torch.zeros_like(w))
    return yt * w[..., None]


def _combine(yb, e_idx, posc, w):
    """(B, SK, D): each slot's expert output times its weight.  On
    DTensors each device gathers from its own experts and rows; where the
    experts are sharded the result is a partial sum over those mesh dims
    (``Partial``), reduced where it is next used."""
    if not shd.is_dtensor(yb):
        B, SK = e_idx.shape
        b_idx = torch.arange(B, device=yb.device)[:, None].expand(B, SK)
        return yb[e_idx, b_idx, posc] * w[..., None]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = yb.device_mesh
    rows = shd.row_placements(e_idx)
    yp, outp = [], []
    for i, p in enumerate(rows):
        if p == Shard(0):
            yp.append(Shard(1)), outp.append(Shard(0))
        elif yb.placements[i] == Shard(0):
            yp.append(Shard(0)), outp.append(Partial())
        else:
            yp.append(Replicate()), outp.append(Replicate())
    yb = yb.redistribute(mesh, yp)
    e_idx, posc, w = (t.redistribute(mesh, rows) for t in (e_idx, posc, w))
    e_off = shd.shard_offset(mesh, yp, 0, yb.to_local().shape[0])
    return shd.local_map(_combine_rows, out_placements=outp,
                     in_placements=(yp, rows, rows, rows, None),
                     device_mesh=mesh)(yb, e_idx, posc, w, e_off)

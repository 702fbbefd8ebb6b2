"""Model assembly: init, forward (prefill) and the decode step.

A Python loop over the layers replaces the JAX package's ``lax.scan``;
``cfg.remat`` is ignored, since nothing here keeps activations for a
backward pass.  Ported: the dense family (llama-style, QKV bias
included), the moe family and rwkv6 (ssm) (``blocks._require_ported``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import blocks as B
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm


class Transformer(nn.Module):
    """Parameters of a decoder: ``embed`` (V, d), ``unembed`` (d, V) when
    the embeddings are untied, ``final_norm`` (d,), and one block per
    layer in ``blocks`` (``DenseBlock``, ``MoEBlock`` or ``RWKVBlock`` by
    family).  The computation is in ``forward`` and ``decode_step``."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        block = {"ssm": B.RWKVBlock, "moe": B.MoEBlock}.get(cfg.family,
                                                           B.DenseBlock)
        B.register_params(self, self.specs(cfg), device, dtype)
        self.blocks = nn.ModuleList(block(cfg, device, dtype)
                                    for _ in range(cfg.n_layers))

    @staticmethod
    def specs(cfg: ModelConfig) -> B.Specs:
        """``repro.models.model.init_params`` (model.py:25-36)."""
        V, d = cfg.vocab_size, cfg.d_model
        specs = {"embed": ((V, d), 0.02)}
        if not cfg.tie_embeddings:
            specs["unembed"] = B.fan_in(d, V)
        specs["final_norm"] = ((d,), "ones")
        return specs


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Transformer:
    """Random weights from ``torch.Generator(seed)`` on ``device``
    (default: the card), drawn in float32 and cast to ``cfg.dtype``.  Each
    parameter is filled as its module's ``specs`` say: ones, zeros, or a
    normal draw of the JAX package's std for that name."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev, torch_dtype(cfg.dtype))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for mod in (model, *model.blocks):
        for name, (shape, init) in mod.specs(cfg).items():
            p = getattr(mod, name)
            if init == "ones":
                p.fill_(1.0)
            elif init == "zeros":
                p.zero_()
            else:
                p.copy_(torch.randn(shape, generator=gen, device=dev,
                                    dtype=torch.float32).mul_(init))
    return model


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _embed(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed[tokens]


def _unembed(model: Transformer, cfg: ModelConfig,
             x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ model.embed.t()
    return x @ model.unembed


# ---------------------------------------------------------------------------
# forward: prefill
# ---------------------------------------------------------------------------

def forward(model: Transformer, cfg: ModelConfig, batch: dict,
            window: Optional[int] = None):
    """Returns (logits (B,S,V), aux_loss): the sum over layers of each
    block's aux (for the moe family the router's load-balance loss times
    ``cfg.router_aux_weight``, else 0).  ``batch["tokens"]``: (B,S)
    integer tensor on the model's device."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    win = cfg.sliding_window if window is None else window
    positions = torch.arange(S, device=tokens.device)
    x = _embed(model, tokens)
    fn = B.block_fwd(cfg, win)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in model.blocks:
        x, a = fn(blk, x, positions)
        aux = aux + a
    x = B.norm_fn(cfg)(x, model.final_norm, cfg.norm_eps)
    return _unembed(model, cfg, x), aux


# ---------------------------------------------------------------------------
# decode: one token against the cache
# ---------------------------------------------------------------------------

def decode_step(model: Transformer, cfg: ModelConfig, cache: dict,
                token: torch.Tensor, pos: int, seq_sharded: bool = False,
                window: Optional[int] = None):
    """token: (B,) integer tensor; pos: int.  Returns (logits (B,V),
    cache); the cache is written in place.  A positive window (default:
    cfg.sliding_window) bounds the attended span."""
    win = cfg.sliding_window if window is None else window
    x = _embed(model, token[:, None])
    fn = B.block_decode(cfg, win, seq_sharded)
    for i, blk in enumerate(model.blocks):
        x = fn(blk, {name: t[i] for name, t in cache.items()}, x, pos)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return _unembed(model, cfg, x)[:, 0], cache

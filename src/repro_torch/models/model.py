"""Model assembly: init, forward (prefill) and the decode step.

A Python loop over the layers replaces the JAX package's ``lax.scan``;
``cfg.remat`` is ignored, since nothing here keeps activations for a
backward pass.  Only llama-style dense models are ported
(``blocks._require_ported``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import blocks as B
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm


class Transformer(nn.Module):
    """Parameters of a dense decoder with tied embeddings: ``embed``
    (V, d), ``final_norm`` (d,), and one ``DenseBlock`` per layer in
    ``blocks``.  The computation is in ``forward`` and ``decode_step``."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        B._require_ported(cfg)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)

        self.embed = param(cfg.vocab_size, cfg.d_model)
        self.final_norm = param(cfg.d_model)
        self.blocks = nn.ModuleList(B.DenseBlock(cfg, device, dtype)
                                    for _ in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_scale(name: str, shape: Tuple[int, ...]) -> Optional[float]:
    """``repro.models.layers.ParamFactory``'s rule: 0.02 for the embedding,
    ones for norms (None), else 1/sqrt(fan_in) with fan_in = shape[-2]."""
    if name == "embed":
        return 0.02
    if len(shape) == 1:
        return None
    return 1.0 / math.sqrt(max(1, shape[-2]))


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Transformer:
    """Random weights from ``torch.Generator(seed)`` on ``device``
    (default: the card), drawn in float32 and cast to ``cfg.dtype``."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev, torch_dtype(cfg.dtype))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        scale = _init_scale(name.rsplit(".", 1)[-1], tuple(p.shape))
        if scale is None:
            p.fill_(1.0)
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device=dev,
                                dtype=torch.float32).mul_(scale))
    return model


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _embed(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed[tokens]


def _unembed(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    return x @ model.embed.t()  # tied embeddings


# ---------------------------------------------------------------------------
# forward: prefill
# ---------------------------------------------------------------------------

def forward(model: Transformer, cfg: ModelConfig, batch: dict,
            window: Optional[int] = None):
    """Returns (logits (B,S,V), aux_loss).  ``batch["tokens"]``: (B,S)
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
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return _unembed(model, x), aux


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
        x = fn(blk, cache["k"][i], cache["v"][i], x, pos)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return _unembed(model, x)[:, 0], cache

"""Model assembly: init, forward (prefill), the loss, the encoder and the
decode step.

A Python loop over the layers replaces the JAX package's ``lax.scan``.
While grad is enabled and the model trains, ``cfg.remat`` wraps each
block, decoder and encoder, in ``torch.utils.checkpoint``
(``jax.checkpoint`` in the JAX package): a block keeps only its input for
the backward pass and runs its forward again there, kernels included.  Every family of the JAX package:
dense, moe, ssm (rwkv6), hybrid (hymba), vlm (stub patch embeddings ahead
of the text) and encdec (whisper: an encoder over stub frame embeddings,
cross K/V per decoder layer, sinusoidal positions and LayerNorms).
Parameters are created frozen; the training entry points
(``repro_torch.train``) turn on ``requires_grad`` for what they train.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import blocks as B
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import layernorm, rmsnorm


class Transformer(nn.Module):
    """Parameters of a model: ``embed`` (V, d), ``unembed`` (d, V) when
    the embeddings are untied, ``final_norm`` (d,), and one block per
    layer in ``blocks`` (``blocks.BLOCKS`` by family); for encdec also the
    encoder's blocks ``enc`` (``EncoderBlock``), its final LayerNorm
    ``enc_norm``/``enc_norm_b`` and the decoder's final bias
    ``final_norm_b``.  The computation is in ``forward``, ``encode`` and
    ``decode_step``."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        block = B.BLOCKS[cfg.family]
        B.register_params(self, self.specs(cfg), device, dtype)
        self.blocks = nn.ModuleList(block(cfg, device, dtype)
                                    for _ in range(cfg.n_layers))
        if cfg.family == "encdec":
            self.enc = nn.ModuleList(B.EncoderBlock(cfg, device, dtype)
                                     for _ in range(cfg.enc_layers))

    @staticmethod
    def specs(cfg: ModelConfig) -> B.Specs:
        """``repro.models.model.init_params`` (model.py:25-48)."""
        V, d = cfg.vocab_size, cfg.d_model
        specs = {"embed": ((V, d), 0.02)}
        if not cfg.tie_embeddings:
            specs["unembed"] = B.fan_in(d, V)
        specs["final_norm"] = ((d,), "ones")
        if cfg.family == "encdec":
            specs.update(enc_norm=((d,), "ones"), enc_norm_b=((d,), "zeros"),
                         final_norm_b=((d,), "zeros"))
        return specs


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Transformer:
    """Random weights from ``torch.Generator(seed)`` on ``device``
    (default: the card), drawn in float32 and cast to ``cfg.dtype``.  Each
    parameter is filled as its module's ``specs`` say: ones, zeros, or a
    normal draw of the JAX package's std for that name.  The decoder's
    blocks are drawn before the encoder's, so a model cut in depth draws
    the same first layers."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev, torch_dtype(cfg.dtype))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for mod in (model, *model.blocks, *getattr(model, "enc", ())):
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

def _sinusoid(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Sinusoidal absolute positions (..., d_model) in float32, computed on
    the fly (decode-safe)."""
    half = d_model // 2
    scale = torch.tensor(math.log(10000.0), dtype=torch.float32) / max(
        1, half - 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * scale.to(positions.device))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed(model: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = model.embed[tokens]
    if cfg.rope_theta <= 0:  # absolute sinusoidal (whisper-style)
        x = x + _sinusoid(positions, cfg.d_model).to(x.dtype)
    return x


def _unembed(model: Transformer, cfg: ModelConfig,
             x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ model.embed.t()
    return x @ model.unembed


def _final_norm(model: Transformer, cfg: ModelConfig, norm, x):
    """encdec's final LayerNorm, else ``norm`` (an RMSNorm)."""
    if cfg.family == "encdec":
        return layernorm(x, model.final_norm, model.final_norm_b,
                         cfg.norm_eps)
    return norm(x, model.final_norm, cfg.norm_eps)


def _remat(model, cfg: ModelConfig) -> bool:
    """Whether ``forward`` checkpoints each block: ``cfg.remat`` asks for
    it (the JAX package's ``jax.checkpoint`` around each block,
    model.py:93-96), grad is enabled and the model trains (a frozen
    model's forward keeps nothing for a backward pass)."""
    return (cfg.remat and torch.is_grad_enabled()
            and any(p.requires_grad for blk in model.blocks
                    for p in blk.parameters()))


def _run_block(remat: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` with ``remat``."""
    if remat:
        return _ckpt.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# encoder (whisper): the frontend's embeddings arrive precomputed (a stub)
# ---------------------------------------------------------------------------

def encode(model: Transformer, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, enc_seq, d_model) stub frame embeddings in the model's
    dtype -> the encoder's output (B, enc_seq, d_model)."""
    positions = torch.arange(frames.shape[1], device=frames.device)
    x = frames + _sinusoid(positions, cfg.d_model).to(frames.dtype)
    fn = B.encoder_block_fwd(cfg)
    remat = _remat(model, cfg)
    for blk in model.enc:
        x = _run_block(remat, fn, blk, x, positions)
    return layernorm(x, model.enc_norm, model.enc_norm_b, cfg.norm_eps)


# ---------------------------------------------------------------------------
# forward: prefill
# ---------------------------------------------------------------------------

def prefill_inputs(model: Transformer, cfg: ModelConfig, batch: dict):
    """The residual stream entering the first block of ``forward``, its
    positions, and the length of the vlm prefix (0 for the others)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    if cfg.family != "vlm":
        positions = torch.arange(S, device=tokens.device)
        return _embed(model, cfg, tokens, positions), positions, 0
    patches = batch["patches"]
    prefix = patches.shape[1]
    positions = torch.arange(prefix + S, device=tokens.device)
    x = torch.cat([patches.to(torch_dtype(cfg.dtype)),
                   _embed(model, cfg, tokens, positions[prefix:])], dim=1)
    return x, positions, prefix


def forward(model: Transformer, cfg: ModelConfig, batch: dict,
            window: Optional[int] = None):
    """Returns (logits (B,S,V), aux_loss): the sum over layers of each
    block's aux (for the moe family the router's load-balance loss times
    ``cfg.router_aux_weight``, else 0).  ``batch`` holds tensors on the
    model's device: ``tokens`` (B,S) integers, always; ``frames``
    (B,enc_seq,d) for encdec; ``patches`` (B,P,d) for vlm, cast to the
    model's dtype and put ahead of the text (logits are the text's)."""
    win = cfg.sliding_window if window is None else window
    x, positions, prefix = prefill_inputs(model, cfg, batch)
    fn = B.block_fwd(cfg, win)
    enc_out = (encode(model, cfg, batch["frames"])
               if cfg.family == "encdec" else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _remat(model, cfg)
    for blk in model.blocks:
        extra = None if enc_out is None else attn.encoder_kv(blk, enc_out)
        x, a = _run_block(remat, fn, blk, x, positions, extra)
        aux = aux + a
    x = _final_norm(model, cfg, B.norm_fn(cfg), x)
    if prefix:
        x = x[:, prefix:]
    return _unembed(model, cfg, x), aux


def loss_fn(model: Transformer, cfg: ModelConfig, batch: dict):
    """Next-token cross entropy + the MoE aux (``repro.models.model.
    loss_fn``, model.py:182-191): the CE over ``log_softmax`` of the
    logits in float32, labels == -1 masked.  Returns (loss, {"ce", "aux"}),
    0-dim float32 tensors."""
    logits, aux = forward(model, cfg, batch)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    lsm = torch.log_softmax(logits.float(), dim=-1)
    ll = lsm.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    ce = -(ll * mask).sum() / mask.sum().clamp_min(1.0)
    return ce + aux, {"ce": ce, "aux": aux}


def batch_tensors(batch: dict, cfg: ModelConfig,
                  device: DeviceLike = None) -> dict:
    """A NumPy batch (``repro_torch.data.pipeline``) as tensors on
    ``device`` (default: the card): tokens and labels int64, the stub
    frontends' ``patches``/``frames`` in the model's dtype."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    return {k: torch.from_numpy(np.asarray(v)).to(
        dev, torch.long if np.issubdtype(np.asarray(v).dtype, np.integer)
        else dt) for k, v in batch.items()}


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
    x = _embed(model, cfg, token[:, None],
               torch.full((1,), pos, device=token.device))
    fn = B.block_decode(cfg, win, seq_sharded)
    for i, blk in enumerate(model.blocks):
        x = fn(blk, {name: t[i] for name, t in cache.items()}, x, pos)
    x = _final_norm(model, cfg, rmsnorm, x)
    return _unembed(model, cfg, x)[:, 0], cache

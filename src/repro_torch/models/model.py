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
from repro_torch.models import sharding as shd
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
        self.cfg = cfg
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
        specs = {"embed": B.spec((V, d), 0.02, ("vocab", "d_model"))}
        if not cfg.tie_embeddings:
            specs["unembed"] = B.fan_in((d, V), ("d_model", "vocab"))
        specs["final_norm"] = B.spec((d,), "ones", B.D)
        if cfg.family == "encdec":
            specs.update(enc_norm=B.spec((d,), "ones", B.D),
                         enc_norm_b=B.spec((d,), "zeros", B.D),
                         final_norm_b=B.spec((d,), "zeros", B.D))
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
    the same first layers.  ``device="meta"`` builds the model at full
    size with no memory and fills nothing (the JAX package's
    ``abstract=True``; the dry run's shapes)."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev, torch_dtype(cfg.dtype))
    if dev.type == "meta":
        return model
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for mod in _param_modules(model):
        for name, (shape, init, _) in mod.specs(cfg).items():
            p = getattr(mod, name)
            if init == "ones":
                p.fill_(1.0)
            elif init == "zeros":
                p.zero_()
            else:
                p.copy_(torch.randn(shape, generator=gen, device=dev,
                                    dtype=torch.float32).mul_(init))
    return model


def _param_modules(model: Transformer):
    return (model, *model.blocks, *getattr(model, "enc", ()))


def param_axes(model_or_cfg) -> dict:
    """The logical axes of every parameter, by the name
    ``model.named_parameters()`` gives it (``blocks.3.wq``): the JAX
    package's axes tree (``init_params(cfg, abstract=True)[1]``) in the
    port's per-layer layout, each stacked entry without its leading
    ``"layer"`` axis, as ``models.convert`` drops it."""
    cfg = (model_or_cfg if isinstance(model_or_cfg, ModelConfig)
           else model_or_cfg.cfg)
    out = {}
    for prefix, cls, n in (("", Transformer, 1),
                           ("blocks.", B.BLOCKS[cfg.family], cfg.n_layers),
                           ("enc.", B.EncoderBlock,
                            cfg.enc_layers if cfg.family == "encdec" else 0)):
        specs = cls.specs(cfg)
        for i in range(n):
            head = f"{prefix}{i}." if prefix else ""
            out.update({head + name: sp.axes for name, sp in specs.items()})
    return out


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
    if shd.is_dtensor(tokens):
        x = _mesh_lookup(model.embed, tokens)
    else:
        x = model.embed[tokens]
    if cfg.rope_theta <= 0:  # absolute sinusoidal (whisper-style)
        x = x + _sinusoid(positions, cfg.d_model).to(x.dtype)
    return x


def _lookup_rows(table, tokens, v_off: int):
    """Rows of ``table`` (this device's vocab rows v_off ...) for
    ``tokens``; tokens outside them give zero rows."""
    t = tokens.long() - v_off
    mine = (t >= 0) & (t < table.shape[0])
    x = table[t.clamp(0, table.shape[0] - 1)]
    return torch.where(mine[..., None], x, torch.zeros_like(x))


def _mesh_lookup(table, tokens):
    """``table[tokens]`` on DTensors: each device looks up the rows it
    holds; where the vocab is sharded the partial rows are all-reduced,
    where d_model is, the rows are all-gathered (explicit redistributes),
    so the residual stream starts whole along d_model."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tp = table.placements
    kp = [Replicate() if isinstance(q, Shard) else p
          for p, q in zip(tokens.placements, tp)]
    tokens = tokens.redistribute(mesh, kp)
    out = []
    for p, q in zip(kp, tp):
        out.append(Partial() if q == Shard(0) else
                   Shard(2) if q == Shard(1) else p)
    v_off = shd.shard_offset(mesh, tp, 0, table.to_local().shape[0])
    x = shd.local_map(_lookup_rows, out_placements=out,
                  in_placements=(tp, kp, None), device_mesh=mesh)(
        table, tokens, v_off)
    return shd.gather_dim(shd.reduce_partial(x), -1)


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


def _seq_constraint(x, seq_axis):
    """Sequence-parallel residual stream (``repro.models.model.
    _seq_constraint``, model.py:79-90): dim 1 of a DTensor sharded over
    ``seq_axis`` (``cfg.seq_shard_axis``) between blocks; a no-op without
    one."""
    if not seq_axis:
        return x
    return shd.pin(x, {1: seq_axis})


def _mesh_block(remat: bool, fn, seq_axis, blk, x, *rest):
    """One block on DTensors (a mesh), the JAX package's scan body
    (model.py:97-103): ``_run_block(remat, fn, blk, x, *rest)`` with the
    residual stream's sequence over ``seq_axis`` before and after, the
    block's pending partial sums reduced and its output's gradient held
    to its placements.  ``fn`` returns x or (x, aux)."""
    out = _run_block(remat, fn, blk, _seq_constraint(x, seq_axis), *rest)
    y, aux = out if isinstance(out, tuple) else (out, None)
    y = shd.pin_grad(_seq_constraint(shd.reduce_partial(y), seq_axis))
    return y if aux is None else (y, aux)


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
    meshed = shd.is_dtensor(x)
    for blk in model.enc:
        if meshed:
            x = _mesh_block(remat, fn, None, blk, x, positions)
        else:
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
    meshed = shd.is_dtensor(x)
    if meshed:
        x = shd.pin_grad(x)
    for blk in model.blocks:
        extra = None if enc_out is None else attn.encoder_kv(blk, enc_out)
        if meshed:
            x, a = _mesh_block(remat, fn, cfg.seq_shard_axis, blk, x,
                               positions, extra)
        else:
            x, a = _run_block(remat, fn, blk, x, positions, extra)
        aux = aux + a
    x = _final_norm(model, cfg, B.norm_fn(cfg), x)
    if meshed:
        x = shd.gather_dim(x, 1)
    if prefix:
        x = x[:, prefix:]
    return _unembed(model, cfg, x), aux


def _picks(lsm: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's log-probability of its label (labels < 0 pick
    class 0; the caller masks them)."""
    return lsm.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]


def _shard_picks(lsm: torch.Tensor, labels: torch.Tensor,
                 v_off: int) -> torch.Tensor:
    """``_picks`` where ``lsm`` holds the classes v_off, v_off + 1, ...
    only: the labels outside them pick 0 (a partial sum)."""
    t = labels.clamp_min(0).long() - v_off
    mine = (t >= 0) & (t < lsm.shape[-1])
    picked = lsm.gather(-1, t.clamp(0, lsm.shape[-1] - 1)[..., None])[..., 0]
    return torch.where(mine, picked, torch.zeros_like(picked))


def _vocab_parallel_picks(logits, labels):
    """The labels' log-probabilities from vocab-sharded DTensor logits
    (float32): the log-sum-exp by a max and a sum over the shards (each an
    all-reduce of one value a position), then each device picks the
    labels in its classes and the partial picks are all-reduced.  No
    device holds a whole row of the vocabulary."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    m = shd.reduce_partial(logits.detach().amax(dim=-1, keepdim=True))
    z = logits - m
    lsm = z - torch.log(shd.reduce_partial(
        torch.exp(z).sum(dim=-1, keepdim=True)))
    vd = Shard(lsm.ndim - 1)
    lp = [Shard(0) if p == Shard(0) else Replicate() for p in lsm.placements]
    out = [Partial() if p == vd else q for p, q in zip(lsm.placements, lp)]
    v_off = shd.shard_offset(mesh, lsm.placements, lsm.ndim - 1,
                             lsm.to_local().shape[-1])
    picks = shd.local_map(_shard_picks, out_placements=out,
                      in_placements=(lsm.placements, lp, None),
                      device_mesh=mesh)(
        lsm, labels.redistribute(mesh, lp), v_off)
    return shd.reduce_partial(picks)


def loss_fn(model: Transformer, cfg: ModelConfig, batch: dict):
    """Next-token cross entropy + the MoE aux (``repro.models.model.
    loss_fn``, model.py:182-191): the CE over ``log_softmax`` of the
    logits in float32, labels == -1 masked.  Returns (loss, {"ce", "aux"}),
    0-dim float32 tensors."""
    logits, aux = forward(model, cfg, batch)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    if shd.shards_dim(logits, -1):
        ll = _vocab_parallel_picks(logits.float(), labels)
    else:
        lsm = torch.log_softmax(logits.float(), dim=-1)
        ll = shd.rowwise(_picks, lsm, labels)
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
    meshed = shd.is_dtensor(x)
    for i, blk in enumerate(model.blocks):
        layer = {name: t[i] for name, t in cache.items()}
        if meshed:
            x = _mesh_block(False, lambda b, h: fn(b, layer, h, pos), None,
                            blk, x)
        else:
            x = fn(blk, layer, x, pos)
    x = _final_norm(model, cfg, rmsnorm, x)
    return _unembed(model, cfg, x)[:, 0], cache

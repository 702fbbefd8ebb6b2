"""Abstract inputs and their shardings for each (architecture x input shape
x mesh): the dry run's contract, the counterpart of ``repro.launch.specs``.

Nothing is allocated here: the model, the optimizer state, the KV cache
and the batch are tensors on the meta device, and each comes with a tree
of specs (``models.sharding``: one mesh axis name, tuple of names or None
per dim) derived from the logical axes.  ``repro_torch.launch.dryrun``
turns them into fake DTensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import torch_dtype
from repro_torch.models import sharding as shd
from repro_torch.models.cache import cache_axes, init_cache
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.model import init_params, param_axes
from repro_torch.train.optimizer import (OptConfig, OptState,
                                         abstract_opt_state)


def long_context_policy(cfg: ModelConfig,
                        shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason).  long_500k needs a sub-quadratic decode path."""
    if shape.name != "long_500k":
        return True, ""
    if cfg.family == "encdec":
        return False, ("enc-dec with full cross-attention and a 448-token "
                       "design context has no sub-quadratic decoder variant "
                       "that preserves the architecture (DESIGN.md §4)")
    if cfg.family in ("ssm", "hybrid"):
        return True, "native O(1)/windowed state"
    if cfg.sliding_window > 0:
        return True, f"sliding-window attention (w={cfg.sliding_window})"
    return False, "full attention is quadratic and no SWA variant configured"


def decode_seq_axis(cfg: ModelConfig, shape: ShapeConfig,
                    model_axis_size: int = 16):
    """Mesh axis for the KV cache's sequence dim (None = unsharded).

    long_500k (batch 1) shards seq over "data".  Ordinary decode shards
    seq over "model" whenever kv_heads does not divide the model axis
    (every GQA config of the pool), because the alternative is a cache
    replicated over the model axis."""
    if shape.kind != "decode":
        return None
    if shape.name == "long_500k":
        return "data"
    if cfg.family == "ssm":
        return None                       # O(1) state, no seq dim
    if cfg.n_kv_heads % model_axis_size != 0:
        return "model"
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def abstract_batch(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The step's batch as meta tensors: int32 ``tokens``/``labels``
    (B, S), as the JAX package's, and the stub frontends' ``patches``
    (vlm) or ``frames`` (encdec), (B, enc_seq, d) in the model's dtype."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, S), torch.int32),
             "labels": _meta((B, S), torch.int32)}
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "vlm":
        batch["patches"] = _meta((B, cfg.enc_seq, cfg.d_model), dt)
    if cfg.family == "encdec":
        batch["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), dt)
    return batch


def batch_shardings(batch: dict, mesh) -> dict:
    return {k: shd.data_pspec(tuple(v.shape), mesh) for k, v in batch.items()}


def abstract_params(cfg: ModelConfig):
    """(the model on the meta device, {name: meta parameter})."""
    model = init_params(cfg, device="meta")
    return model, dict(model.named_parameters())


def param_shardings(model, mesh) -> dict:
    params = dict(model.named_parameters())
    return shd.param_specs(param_axes(model),
                           {n: tuple(p.shape) for n, p in params.items()},
                           mesh)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                oc: Optional[OptConfig] = None):
    """Returns (args, specs, meta) for the step kind of ``shape``:

    train:   step(model, opt_state, batch)
    prefill: forward(model, batch)
    decode:  serve_step(model, cache, token, pos)

    ``args`` hold the meta model and meta tensors, ``specs`` mirror them
    (the model's by parameter name); ``pos`` is a 0-dim int32, as in the
    JAX package, though the port's step takes it as a host integer."""
    model, params = abstract_params(cfg)
    psh = param_shardings(model, mesh)
    meta = {"seq_sharded": False}

    if shape.kind == "train":
        oc = oc or OptConfig()
        opt = abstract_opt_state(params, oc)
        opt_sh = OptState(shd.replicated(0), dict(psh), dict(psh))
        batch = abstract_batch(cfg, shape)
        return ((model, opt, batch), (psh, opt_sh, batch_shardings(batch, mesh)),
                meta)

    if shape.kind == "prefill":
        batch = abstract_batch(cfg, shape)
        return (model, batch), (psh, batch_shardings(batch, mesh)), meta

    seq_axis = decode_seq_axis(cfg, shape)
    meta["seq_sharded"] = seq_axis is not None
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    csh = shd.cache_specs(cache_axes(cfg),
                          {n: tuple(c.shape) for n, c in cache.items()},
                          mesh, seq_axis)
    token = _meta((shape.global_batch,), torch.int32)
    tsh = shd.data_pspec(tuple(token.shape), mesh)
    pos = _meta((), torch.int32)
    return (model, cache, token, pos), (psh, csh, tsh, shd.replicated(0)), meta

"""Load the JAX package's parameters into the port's modules.

``params_from_numpy`` takes the JAX parameter tree as NumPy arrays
(``jax.tree.map(np.asarray, params)``: per-layer arrays stacked on a
leading layer axis) and returns a ``Transformer`` holding the same values,
so that the two packages compute the same function.  It needs NumPy only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Transformer


def _copy(dst: torch.Tensor, src, name: str):
    # bfloat16 arrays pass through float32 exactly
    arr = np.asarray(src, dtype=np.float32)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {arr.shape} does not match "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.tensor(arr))


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: DeviceLike = None) -> Transformer:
    dev = resolve_device(device)
    model = Transformer(cfg, dev, torch_dtype(cfg.dtype))
    blocks = tree["blocks"]
    top = {k for k in tree if k != "blocks"}
    want_top = {n for n, _ in model.named_parameters(recurse=False)}
    want_blk = {n for n, _ in model.blocks[0].named_parameters()}
    if top != want_top or set(blocks) != want_blk:
        raise ValueError(f"parameter names differ: tree has "
                         f"{sorted(top)} + blocks {sorted(blocks)}, model "
                         f"wants {sorted(want_top)} + {sorted(want_blk)}")
    for name, p in model.named_parameters(recurse=False):
        _copy(p, tree[name], name)
    for i, blk in enumerate(model.blocks):
        for name, p in blk.named_parameters():
            _copy(p, np.asarray(blocks[name])[i], f"blocks.{name}[{i}]")
    return model

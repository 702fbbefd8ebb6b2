"""Load the JAX package's parameters into the port's modules.

``params_from_numpy`` takes the JAX parameter tree as NumPy arrays
(``jax.tree.map(np.asarray, params)``: per-layer arrays stacked on a
leading layer axis, under ``blocks`` and, for encdec, ``enc``) and
returns a ``Transformer`` holding the same values, so that the two
packages compute the same function.  It needs NumPy only.
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
    """The names must match the model's exactly: the top level, the
    stacked ``blocks`` and, for encdec, the stacked encoder ``enc``."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev, torch_dtype(cfg.dtype))
    stacks = {name: getattr(model, name) for name in ("blocks", "enc")
              if hasattr(model, name)}
    top = {k for k in tree if k not in stacks}
    want_top = {n for n, _ in model.named_parameters(recurse=False)}
    have = {name: set(tree.get(name, ())) for name in stacks}
    want = {name: {n for n, _ in mods[0].named_parameters()}
            for name, mods in stacks.items()}
    if top != want_top or have != want:
        raise ValueError(f"parameter names differ: tree has {sorted(top)} "
                         f"+ {_sorted(have)}, model wants "
                         f"{sorted(want_top)} + {_sorted(want)}")
    for name, p in model.named_parameters(recurse=False):
        _copy(p, tree[name], name)
    for stack, mods in stacks.items():
        for i, blk in enumerate(mods):
            for name, p in blk.named_parameters():
                _copy(p, np.asarray(tree[stack][name])[i],
                      f"{stack}.{name}[{i}]")
    return model


def _sorted(names: dict) -> dict:
    return {k: sorted(v) for k, v in names.items()}

"""Minimal dependency-free checkpointing (npz + a pickle of the structure).

The counterpart of ``repro.train.checkpoint`` for the HadarE
checkpoint/restart path: a preempted job saves (parameters, optimizer
state, step) and a later round restores them, maybe on another node.
``save`` takes a tree of tensors (``_tree``: nested dicts, lists, tuples
and ``OptState``s) and writes a pickle of its structure, names, shapes and
dtypes, then an npz of the leaves.  The pickle holds only Python builtins,
so the file loads without the port (NumPy and ``pickle`` read it).
bfloat16, which npz cannot store, is stored as float32 (exact) and
restored as bfloat16, as ``repro/train/checkpoint.py:26-55`` does.
"""
from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train._tree import is_namedtuple
from repro_torch.train.optimizer import OptState

_NAMEDTUPLES = {"OptState": OptState}


def _flatten(tree, arrays: list, dtypes: list):
    """The structure of ``tree`` as builtins; its leaves appended to
    ``arrays`` (NumPy) and their dtype names to ``dtypes``."""
    if isinstance(tree, dict):
        return {"dict": [(k, _flatten(v, arrays, dtypes))
                         for k, v in tree.items()]}
    if is_namedtuple(tree):
        return {"namedtuple": type(tree).__name__,
                "fields": [_flatten(v, arrays, dtypes) for v in tree]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_flatten(v, arrays, dtypes)
                                      for v in tree]}
    t = torch.as_tensor(tree).detach().cpu()
    dtypes.append(str(t.dtype).removeprefix("torch."))
    if t.dtype == torch.bfloat16:
        t = t.float()  # npz can't store bf16
    arrays.append(t.numpy())
    return {"leaf": len(arrays) - 1, "shape": list(t.shape)}


def save(path: str, tree) -> None:
    arrays, dtypes = [], []
    struct = _flatten(tree, arrays, dtypes)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"structure": struct, "n": len(arrays),
                     "dtypes": dtypes}, f)
        np.savez(f, **{f"a{i}": a for i, a in enumerate(arrays)})


def _unflatten(struct, leaves: list):
    if "dict" in struct:
        return {k: _unflatten(v, leaves) for k, v in struct["dict"]}
    if "namedtuple" in struct:
        fields = [_unflatten(v, leaves) for v in struct["fields"]]
        cls = _NAMEDTUPLES.get(struct["namedtuple"])
        return cls(*fields) if cls else tuple(fields)
    if "list" in struct:
        return [_unflatten(v, leaves) for v in struct["list"]]
    if "tuple" in struct:
        return tuple(_unflatten(v, leaves) for v in struct["tuple"])
    return leaves[struct["leaf"]]


def restore(path: str, device: DeviceLike = None):
    """The tree ``save`` wrote, its tensors on ``device`` (default: the
    card) in their saved dtypes."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        meta = pickle.load(f)
        data = np.load(io.BytesIO(f.read()))
    leaves = []
    for i in range(meta["n"]):
        t = torch.from_numpy(np.array(data[f"a{i}"]))
        leaves.append(t.to(dev, getattr(torch, meta["dtypes"][i])))
    return _unflatten(meta["structure"], leaves)

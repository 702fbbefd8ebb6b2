"""HadarE parameter consolidation (paper §V-B).

Copies of a job trained on different nodes are merged each round by
weight-averaging their parameters, weighted by the number of training
steps each copy completed (more capable nodes contribute more steps and
so more weight).  The counterpart of ``repro.train.consolidate``
(consolidate.py:21-55), on trees of tensors (``_tree``):

  * ``weight_average(params_list, steps)``: the host-side average that
    the scheduled-training driver uses (copies live as separate trees);
  * ``consolidate_into(base, update, alpha)``: an incremental merge;
  * ``pod_consolidate(stacked, steps)``: the weighted mean over a leading
    copy dim of each leaf (a tensordot over it, as in the JAX package).

Each averages in float32 and casts once to the leaf's dtype.  On
DTensors whose copy dim is sharded over the ``pod`` mesh axis
(``pod_consolidate_shardings``), ``pod_consolidate`` averages each
device's copies locally and all-reduces the float32 partial sums over
``pod`` before the cast, as the JAX package's GSPMD lowering does.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.models import sharding as shd
from repro_torch.train._tree import leaves, tree_map


def weight_average(params_list: List, steps: Sequence[float]):
    """Weighted average of N trees of the same structure; weights ∝
    steps."""
    dev = leaves(params_list[0])[0].device
    w = torch.as_tensor(steps, dtype=torch.float32, device=dev)
    w = w / torch.clamp(w.sum(), min=1e-9)

    def avg(*ls):
        acc = sum(l.float() * w[i] for i, l in enumerate(ls))
        return acc.to(ls[0].dtype)

    return tree_map(avg, *params_list)


def consolidate_into(base, update, alpha: float):
    """base <- (1-alpha)*base + alpha*update (incremental merge)."""
    return tree_map(lambda b, u: ((1 - alpha) * b.float()
                                  + alpha * u.float()).to(b.dtype),
                    base, update)


def pod_consolidate(stacked_params, steps: torch.Tensor):
    """Each leaf has a leading ``n_copies`` dim; returns the
    steps-weighted mean over it, in the leaf's dtype."""
    w = steps.float()
    w = w / torch.clamp(w.sum(), min=1e-9)

    def avg(p):
        if shd.is_dtensor(p):
            return _mesh_avg(w, p)
        out = torch.tensordot(w.to(p.device), p.float(), dims=([0], [0]))
        return out.to(p.dtype)

    return tree_map(avg, stacked_params)


def _local_avg(w: torch.Tensor, p: torch.Tensor, off: int) -> torch.Tensor:
    """This device's copies ``p`` (the copies off, off + 1, ...) weighted
    by their part of ``w``, summed in float32."""
    wl = w[off:off + p.shape[0]]
    return torch.tensordot(wl.to(p.device), p.float(), dims=([0], [0]))


def _mesh_avg(w, p):
    """``avg`` of one DTensor leaf: each device sums its copies (a partial
    sum over the mesh dims that shard the copy dim), an explicit
    redistribute all-reduces it in float32, then the cast."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from torch.distributed.tensor.experimental import local_map
    mesh = p.device_mesh
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w.to(p.to_local().device), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
    off = shd.shard_offset(mesh, p.placements, 0, p.to_local().shape[0])
    outp = []
    for pl in p.placements:
        if pl == Shard(0):
            outp.append(Partial())
        elif isinstance(pl, Shard):
            outp.append(Shard(pl.dim - 1))
        else:
            outp.append(pl)
    part = local_map(_local_avg, out_placements=outp,
                     in_placements=([Replicate()] * mesh.ndim, p.placements,
                                    None),
                     device_mesh=mesh)(w, p, off)
    full = [Replicate() if isinstance(pl, Partial) else pl for pl in outp]
    return part.redistribute(mesh, full).to(p.dtype)


def pod_consolidate_shardings(param_specs: dict, axis: str = "pod"):
    """(in, out) specs of ``pod_consolidate``: each input leaf gets its
    leading copy dim sharded over ``axis`` ahead of the parameter's spec
    (``Shard(0)`` over pod, before its placements); the outputs keep the
    parameter's spec (replicated over pod)."""
    ins = {n: (axis,) + tuple(spec) for n, spec in param_specs.items()}
    return ins, dict(param_specs)

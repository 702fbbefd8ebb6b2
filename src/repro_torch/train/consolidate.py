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

Each averages in float32 and casts once to the leaf's dtype.
``pod_consolidate_shardings`` and the process-group all-reduce of the
copies wait for the port's mesh slice.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

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
        out = torch.tensordot(w.to(p.device), p.float(), dims=([0], [0]))
        return out.to(p.dtype)

    return tree_map(avg, stacked_params)

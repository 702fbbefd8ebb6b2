"""Hand-rolled optimizers: AdamW with decoupled weight decay, SGD with
momentum, global-norm clipping and the warmup-cosine schedule.

A copy of ``repro.train.optimizer`` (optimizer.py:1-109) on trees of
tensors (``_tree``; the train step passes a dict name -> parameter).  The
moments are float32 whatever the parameter's dtype; the clip returns
float32 grads; each update is computed in float32 and cast once to the
parameter's dtype; weight decay applies to every leaf.  Every function is
pure: it returns new tensors and leaves its arguments as they were.
(``torch.optim.AdamW`` is no substitute: it keeps bf16 moments for bf16
parameters and orders the decay differently.)  ``abstract_opt_state``
gives the state's shapes on the meta device, for the dry run
(``repro_torch.launch.specs``), where the moments take the parameters'
placements and ``step`` is replicated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.train._tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    kind: str = "adamw"  # "adamw" | "sgdm"


class OptState(NamedTuple):
    """``step``: a 0-dim tensor, int32 from ``init_opt_state`` (HadarE's
    steps-weighted averaging of copies makes it a fractional float32, as
    in the JAX package); ``mu``, ``nu``: trees of float32 moments shaped
    like the parameters (for sgdm ``nu`` is unused)."""
    step: torch.Tensor
    mu: dict
    nu: dict


def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac, float32."""
    s = step.float()
    warm = s / max(1.0, oc.warmup_steps)
    prog = ((s - oc.warmup_steps)
            / max(1.0, oc.total_steps - oc.warmup_steps)).clamp(0.0, 1.0)
    cos = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return oc.lr * torch.where(s < oc.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares,
    added leaf by leaf in order."""
    total = sum(l.float().square().sum() for l in leaves(tree))
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """(the leaves in float32 times min(1, max_norm / (norm + 1e-9)), the
    norm)."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / (n + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, tree), n


def init_opt_state(params, oc: OptConfig) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    mu = tree_map(zeros, params)
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    if oc.kind == "sgdm":
        return OptState(step, mu, mu)
    return OptState(step, mu, tree_map(zeros, params))


def abstract_opt_state(abstract_params, oc: OptConfig) -> OptState:
    """The state of ``init_opt_state`` as shapes only (meta tensors): a
    0-dim int32 ``step``, float32 ``mu`` and ``nu`` shaped like each
    parameter (``repro.train.optimizer.abstract_opt_state``)."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    mu = tree_map(f32, abstract_params)
    return OptState(torch.empty((), dtype=torch.int32, device="meta"), mu,
                    tree_map(f32, abstract_params))


def apply_updates(params, grads, state: OptState, oc: OptConfig):
    """Returns (new_params, new_state, {"lr", "grad_norm"})."""
    grads, gnorm = clip_by_global_norm(grads, oc.grad_clip)
    step = state.step + 1
    lr = schedule(oc, step)

    if oc.kind == "sgdm":
        mu = tree_map(lambda m, g: oc.b1 * m + g, state.mu, grads)
        new_params = tree_map(
            lambda p, m: (p.float() - lr * m - lr * oc.weight_decay
                          * p.float()).to(p.dtype),
            params, mu)
        return new_params, OptState(step, mu, state.nu), \
            {"lr": lr, "grad_norm": gnorm}

    t = step.float()
    bc1 = 1 - oc.b1 ** t
    bc2 = 1 - oc.b2 ** t
    mu = tree_map(lambda m, g: oc.b1 * m + (1 - oc.b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: oc.b2 * v + (1 - oc.b2) * torch.square(g),
                  state.nu, grads)

    def upd(p, m, v):
        mh = m / bc1
        vh = v / bc2
        pf = p.float()
        step_ = mh / (torch.sqrt(vh) + oc.eps) + oc.weight_decay * pf
        return (pf - lr * step_).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, OptState(step, mu, nu), \
        {"lr": lr, "grad_norm": gnorm}

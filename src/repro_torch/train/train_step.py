"""The training step (loss -> grads -> optimizer update).

A copy of ``repro.train.train_step`` (train_step.py:1-74).
``make_train_step(cfg, oc, microbatches)`` returns
    step(model, opt_state, batch) -> (model, opt_state, metrics)
with ``loss``, ``ce``, ``aux``, ``lr`` and ``grad_norm`` (0-dim tensors on
the model's device).  The gradient is ``torch.autograd.grad`` of
``models.model.loss_fn`` with respect to every parameter of ``model``
(``jax.value_and_grad`` in the JAX package); on the kernel path
(``cfg.attn_impl == "pallas"``) it runs through the backward kernels K1b,
K2b and K3b (``kernels.ops``).  Unlike the JAX package's pure step, this
one writes the updated parameters into ``model`` in place (saving a second
copy of the weights) and returns it; the optimizer state is returned new.
With ``microbatches > 1`` the batch is cut along its first dim, the float32
grads are averaged over the pieces, and ``aux`` reads 0, as the JAX
package's accumulated step does (train_step.py:43-62).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.train.optimizer import OptConfig, OptState, apply_updates


def trainable(model) -> Dict[str, torch.Tensor]:
    """Every parameter of ``model`` by name, each with ``requires_grad``
    turned on (the model's parameters are created frozen)."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


@torch.no_grad()
def load_params(model, params: Dict[str, torch.Tensor]):
    """Copy ``params`` (name -> tensor, the names of
    ``model.named_parameters()``) into ``model``'s parameters in place."""
    own = dict(model.named_parameters())
    if set(own) != set(params):
        raise ValueError(f"parameter names differ: {sorted(set(own) ^ set(params))}")
    for name, p in own.items():
        p.copy_(params[name])
    return model


def make_loss(cfg: ModelConfig):
    def f(model, batch):
        return loss_fn(model, cfg, batch)

    return f


def _grads(loss_f, model, batch):
    """(loss, metrics, grads name -> tensor in each parameter's dtype)."""
    params = trainable(model)
    with torch.enable_grad():
        l, metrics = loss_f(model, batch)
        grads = torch.autograd.grad(l, list(params.values()),
                                    allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), grads)}
    return l.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _update(model, grads, opt_state: OptState, oc: OptConfig):
    params = {n: p.detach() for n, p in model.named_parameters()}
    new, opt_state, om = apply_updates(params, grads, opt_state, oc)
    load_params(model, new)
    return opt_state, om


def make_train_step(cfg: ModelConfig, oc: OptConfig,
                    microbatches: int = 1) -> Callable:
    loss = make_loss(cfg)

    def single(model, opt_state: OptState, batch):
        l, metrics, grads = _grads(loss, model, batch)
        opt_state, om = _update(model, grads, opt_state, oc)
        return model, opt_state, dict(metrics, loss=l, **om)

    if microbatches <= 1:
        return single

    def accumulated(model, opt_state: OptState, batch):
        n = next(iter(batch.values())).shape[0] // microbatches
        acc, lsum = None, None
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            l, _, g = _grads(loss, model, mb)
            acc = ({k: t.float() for k, t in g.items()} if acc is None else
                   {k: acc[k] + t for k, t in g.items()})
            lsum = l if lsum is None else lsum + l
        grads = {k: t / microbatches for k, t in acc.items()}
        l = lsum / microbatches
        opt_state, om = _update(model, grads, opt_state, oc)
        return model, opt_state, dict(loss=l, ce=l,
                                      aux=torch.zeros((), device=l.device),
                                      **om)

    return accumulated


def make_eval_step(cfg: ModelConfig) -> Callable:
    loss = make_loss(cfg)

    @torch.no_grad()
    def step(model, batch):
        l, m = loss(model, batch)
        return dict(m, loss=l)

    return step

"""Logical axis -> mesh sharding, with the divisibility fallback.

A copy of ``repro.models.sharding``'s rules (sharding.py:22-126).  Every
parameter carries logical axis names (``Spec.axes``, ``model.param_axes``).
For each tensor *one* axis is sharded over the ``model`` mesh axis, chosen
by priority:

    experts > heads > kv_heads > d_ff > heads_flat > vocab > d_model

skipping axes whose size does not divide the mesh axis (grok-1's 8
experts on model=16 fall through to d_ff: tensor-parallel experts;
whisper-tiny's 6 heads fall through to d_model).  Activations shard the
batch over (pod, data); long_500k (batch 1) shards the cache's sequence
dim over ``data`` instead.

A spec is what the JAX package's ``PartitionSpec`` holds: one entry per
tensor dim, None, a mesh axis name, or a tuple of names.
``to_placements`` turns it into DTensor placements on a ``DeviceMesh``:
a dim sharded over ("pod", "data") becomes ``Shard(d)`` on both mesh
dims, pod major, as JAX orders it.  The resolvers need only the mesh's
axis names and sizes, so they take a ``DeviceMesh``, a dict name -> size,
or anything with ``axis_names`` and ``devices.shape``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

PARAM_PRIORITY = ("experts", "heads", "kv_heads", "d_ff", "heads_flat",
                  "vocab", "d_model")

# Contracting-dim ("d_model") sharding of a weight makes every consumer
# produce partial sums: one activation all-reduce per layer per use.  That
# only pays where replicating the tensor would dominate memory; below this
# element count the tensor is replicated instead.
D_MODEL_SHARD_MIN_ELEMS = 2 ** 23

Spec = Tuple[object, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh axis name -> size, in the mesh's order."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh)[name]


def param_pspec(logical, shape, mesh, model_axis: str = "model") -> Spec:
    sizes = axis_sizes(mesh)
    spec = [None] * len(shape)
    if model_axis in sizes:
        size = sizes[model_axis]
        nelems = 1
        for ax, s in zip(logical, shape):
            if ax != "layer":          # per-layer size, not stacked size
                nelems *= max(1, s)
        for cand in PARAM_PRIORITY:
            if cand in logical:
                if cand == "d_model" and nelems < D_MODEL_SHARD_MIN_ELEMS:
                    continue
                i = logical.index(cand)
                if shape[i] % size == 0 and shape[i] > 0:
                    spec[i] = model_axis
                    break
    return tuple(spec)


def batch_axes(mesh) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _div(n: int, mesh, axes) -> Optional[tuple]:
    if not axes:
        return None
    total = 1
    for a in axes:
        total *= _axis_size(mesh, a)
    return axes if n % total == 0 else None


def data_pspec(shape, mesh, seq_dim: Optional[int] = None) -> Spec:
    """Shard dim 0 (batch) over (pod, data); where it does not divide,
    optionally a sequence dim over ``data`` instead."""
    sizes = axis_sizes(mesh)
    spec = [None] * len(shape)
    ba = _div(shape[0], mesh, batch_axes(mesh))
    if ba:
        spec[0] = ba if len(ba) > 1 else ba[0]
    elif seq_dim is not None and "data" in sizes \
            and shape[seq_dim] % sizes["data"] == 0:
        spec[seq_dim] = "data"
    return tuple(spec)


def cache_pspec(logical, shape, mesh, seq_axis=None) -> Spec:
    """Cache entries: (layer, batch, [seq], heads-ish, ...).

    ``seq_axis``: the mesh axis of the cache's sequence dim: "data" for
    long_500k (batch 1), "model" for ordinary decode when kv_heads does not
    divide the model axis (every GQA config of the pool on a 16-wide axis;
    without it the whole cache replicates across the model axis)."""
    sizes = axis_sizes(mesh)
    spec = [None] * len(shape)
    for i, ax in enumerate(logical):
        if ax == "batch" and seq_axis != "data":
            ba = _div(shape[i], mesh, batch_axes(mesh))
            if ba:
                spec[i] = ba if len(ba) > 1 else ba[0]
        elif ax == "seq" and seq_axis and seq_axis in sizes:
            if shape[i] % sizes[seq_axis] == 0:
                spec[i] = seq_axis
        elif ax in ("kv_heads", "heads", "d_ff") and "model" in sizes:
            if seq_axis == "model":
                continue
            if shape[i] % sizes["model"] == 0:
                spec[i] = "model"
    return tuple(spec)


def param_specs(axes: Dict[str, tuple], shapes: Dict[str, Sequence[int]],
                mesh) -> Dict[str, Spec]:
    """``param_pspec`` of every parameter by name (``model.param_axes``
    and the parameters' shapes)."""
    return {n: param_pspec(axes[n], tuple(shapes[n]), mesh) for n in axes}


def cache_specs(axes: Dict[str, tuple], shapes: Dict[str, Sequence[int]],
                mesh, seq_axis=None) -> Dict[str, Spec]:
    return {n: cache_pspec(axes[n], tuple(shapes[n]), mesh, seq_axis)
            for n in axes}


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): for
    each mesh dim, ``Shard(d)`` where tensor dim d names that axis, else
    ``Replicate()``.  A dim over several axes must name them in the mesh's
    order (major first), the only order a placement list can say."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(axis_sizes(mesh))
    out = [Replicate() for _ in order]
    for d, entry in enumerate(spec):
        names = _names(entry)
        idx = [order.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} names {names} out of the mesh's "
                             f"order {order}")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """Each device's shard of a tensor of ``shape`` under ``spec``; every
    sharded dim must divide, as the resolvers above guarantee."""
    sizes = axis_sizes(mesh)
    out = []
    for s, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = 1
        for a in _names(entry):
            n *= sizes[a]
        if s % n:
            raise ValueError(f"dim of {s} does not divide over {entry}")
        out.append(s // n)
    return tuple(out)


def replicated(ndim: int) -> Spec:
    return (None,) * ndim


# ---------------------------------------------------------------------------
# Under a mesh: the model's tensors are DTensors (the dry run); these
# helpers are no-ops on plain tensors.
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor_type())


@functools.cache
def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def pin(x, dims: Dict[int, object]):
    """``with_sharding_constraint`` on a DTensor: tensor dim d sharded over
    the mesh axes ``dims[d]`` (a name or a tuple of names, in the mesh's
    order); every other mesh dim keeps its placement, unless it shards a
    pinned dim (then it replicates).  An explicit ``redistribute``, so the
    collectives it takes are recorded.  A plain tensor passes unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    order = list(mesh.mesh_dim_names)
    want = {}
    for d, entry in dims.items():
        for name in _names(entry):
            if name in order:
                want[order.index(name)] = Shard(d % x.ndim)
    pinned = {d % x.ndim for d in dims}
    out = []
    for i, p in enumerate(x.placements):
        if i in want:
            out.append(want[i])
        elif isinstance(p, Shard) and p.dim in pinned:
            out.append(Replicate())
        else:
            out.append(p)
    if tuple(out) == tuple(x.placements):
        return x
    return x.redistribute(mesh, out)


def reduce_partial(x):
    """A DTensor's pending (partial) sums reduced now, by an explicit
    redistribute to ``Replicate`` on those mesh dims."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def gather_dim(x, dim: int):
    """A DTensor with dim ``dim`` whole on every device (an explicit
    all-gather over the mesh dims that shard it)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    d = dim % x.ndim
    out = [Replicate() if p == Shard(d) else p for p in x.placements]
    if out == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, out)


def shard_offset(mesh, placements, dim: int, local_size: int) -> int:
    """The global index of this device's first element along tensor dim
    ``dim`` (of ``local_size`` per device) under ``placements``: the mesh
    dims that shard it, major first."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    off, stride = 0, local_size
    for i in reversed(range(mesh.ndim)):
        if placements[i] == Shard(dim):
            off += coord[i] * stride
            stride *= mesh.size(i)
    return off


def shards_dim(x, dim: int) -> bool:
    """Whether ``x`` is a DTensor with tensor dim ``dim`` sharded."""
    if not is_dtensor(x):
        return False
    from torch.distributed.tensor import Shard
    return Shard(dim % x.ndim) in x.placements


def _grad_pin_fn():
    import torch

    class GradPin(torch.autograd.Function):
        """Identity forward; the gradient redistributed to the forward
        value's placements (partial sums reduced), as a sharding
        constraint in the JAX package holds the cotangent too."""

        @staticmethod
        def forward(ctx, x):
            ctx.mesh, ctx.placements = x.device_mesh, x.placements
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            from torch.distributed.tensor import Replicate
            want = [Replicate() if p.is_partial() else p
                    for p in ctx.placements]
            if list(g.placements) == want:
                return g
            return g.redistribute(ctx.mesh, want)

    return GradPin


_GRAD_PIN = []


def pin_grad(x):
    """On a DTensor that autograd tracks: its gradient takes x's own
    placements (an explicit redistribute in the backward), so that the
    backward does not wander into shardings the forward never had."""
    if not (is_dtensor(x) and x.requires_grad):
        return x
    if not _GRAD_PIN:
        _GRAD_PIN.append(_grad_pin_fn())
    return _GRAD_PIN[0].apply(x)


def row_placements(x):
    """Placements that keep x's dim-0 (batch) shards and replicate the
    rest: what a row-local computation takes."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if p == Shard(0) else Replicate() for p in x.placements]


def local_map(fn, out_placements, in_placements, device_mesh):
    """``torch.distributed.tensor.experimental.local_map`` with the
    placements of its inputs' gradients given: an input replicated on a
    mesh dim where another input is sharded meets only this device's
    share of the work, so its gradient there is a partial sum
    (``Partial``), not the replicated value that ``local_map`` assumes
    by default."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map as lm
    split = [any(pl is not None and isinstance(pl[i], Shard)
                 for pl in in_placements)
             for i in range(device_mesh.ndim)]
    grads = tuple(None if pl is None else
                  [Partial() if p == Replicate() and split[i] else p
                   for i, p in enumerate(pl)]
                  for pl in in_placements)
    return lm(fn, out_placements=out_placements, in_placements=in_placements,
              in_grad_placements=grads, device_mesh=device_mesh)


def rowwise(fn, *args):
    """``fn(*args)`` for a computation local to each row of dim 0; on
    DTensors each device runs it on its rows (``local_map``: every tensor
    argument and the result sharded on dim 0 as the first argument's
    batch is, replicated elsewhere, after explicit redistributes), so its
    backward stays local too.  Plain tensors call ``fn`` directly."""
    x = args[0]
    if not is_dtensor(x):
        return fn(*args)
    pl = row_placements(x)
    ins = tuple(a.redistribute(x.device_mesh, pl)
                if is_dtensor(a) else a for a in args)
    return local_map(fn, out_placements=pl,
                     in_placements=tuple(pl if is_dtensor(a) else None
                                         for a in args),
                     device_mesh=x.device_mesh)(*ins)

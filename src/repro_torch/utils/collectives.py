"""Collective and cost accounting of a traced step: the counterpart of
``repro.utils.hlo``.

The JAX package parses the compiled (post-SPMD) HLO text.  The port has no
HLO: ``Recorder``, a ``TorchDispatchMode``, sees every local op that a
step on DTensors issues (it lets DTensor run first, so what it sees is
each device's program on its shards) and records for each op its kind,
its local operand and result bytes, its matmul FLOPs, and whether it ran
inside a block.  The collectives are the ``_c10d_functional`` ops that
DTensor's redistributions issue.  The accounting convention is
``hlo.py``'s (hlo.py:1-12):

  * all-gather / all-to-all / collective-permute: result bytes
  * all-reduce: 2 x result bytes (reduce + broadcast phases of a ring)
  * reduce-scatter: result bytes

``scope("body")`` marks ops inside a block's module (the layer loop, in
the forward, the backward and the recomputation), standing in for the
reference's scan body; the rest is ``entry``.  Unlike the scan body, which
``cost_analysis`` counts once, a block here runs once per layer and each
run is counted.

The recorder also keeps the peak of live local storage allocated while it
is on (``peak_bytes``): the storages its ops created, each counted while
a tensor that the recorder saw still refers to it.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Dict, List, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}

_SCOPE: List[str] = ["entry"]
_PAUSED = [0]


def _pause_during_propagation():
    """DTensor derives each op's output shape by running the op once on
    fake tensors of the *global* shapes (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``); no device runs that, so the
    recorder pauses inside it.  Installed once, on first use."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    fn = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(fn, "_paused_wrapper", False):
        return

    def wrapper(self, *args, **kwargs):
        _PAUSED[0] += 1
        try:
            return fn(self, *args, **kwargs)
        finally:
            _PAUSED[0] -= 1

    wrapper._paused_wrapper = True
    ShardingPropagator._propagate_tensor_meta_non_cached = wrapper


@contextlib.contextmanager
def scope(name: str):
    """Ops issued inside are recorded under ``name`` ("body" or "entry")."""
    _SCOPE.append(name)
    try:
        yield
    finally:
        _SCOPE.pop()


def enter_scope(name: str):
    """Switch the scope without a ``with`` block (the backward's hooks)."""
    _SCOPE[-1] = name


def mark_backward(t, name: str):
    """On a DTensor that autograd tracks: switch the scope to ``name`` when
    its gradient is computed (a block's output -> "body", the first
    block's input -> "entry"), so the backward is split as the forward
    is.  Plain tensors are left alone."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor) and t.requires_grad:
        t.register_hook(lambda g: enter_scope(name))


class Op(NamedTuple):
    name: str           # the aten / c10d op, e.g. "aten.mm.default"
    kind: str           # a collective's kind (``_KINDS``) or "" for compute
    scope: str
    result_bytes: int   # local bytes of the outputs
    operand_bytes: int  # local bytes of the tensor inputs
    flops: int          # matmul FLOPs on the local shapes
    shapes: tuple       # the outputs' local shapes
    group: str = ""     # a collective's process group (its name)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _is_dtensor_type(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class Recorder(TorchDispatchMode):
    """Records every local op of the steps run inside it (``ops``) and the
    peak of live local storage (``peak_bytes``)."""

    def __init__(self):
        super().__init__()
        _pause_during_propagation()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.ops: List[Op] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._refs: Dict[int, list] = {}

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        entry = self._refs.get(key)
        if entry is None:
            entry = self._refs[key] = [0, st.nbytes()]
            self.live_bytes += entry[1]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int):
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self.live_bytes -= entry[1]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_type(types):
            return NotImplemented         # let DTensor lower it to local ops
        out = func(*args, **kwargs)
        if _PAUSED[0]:
            return out
        packet = func._overloadpacket
        kind, group = "", ""
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            kind = _KINDS.get(packet.__name__, "")
            names = [a for a in args if isinstance(a, str)]
            group = names[-1] if names else ""
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        flops = 0
        if packet in self._flops:
            flops = int(self._flops[packet](*args, **kwargs, out_val=out))
        view = func.is_view
        self.ops.append(Op(
            str(func), kind, _SCOPE[-1],
            0 if view else sum(_nbytes(t) for t in outs),
            0 if view else sum(_nbytes(t) for t in ins),
            flops, tuple(tuple(t.shape) for t in outs), group))
        for t in outs:
            self._track(t)
        return out

    # --- summaries ------------------------------------------------------
    def flops(self) -> int:
        return sum(o.flops for o in self.ops)

    def bytes_accessed(self) -> int:
        return sum(o.result_bytes + o.operand_bytes for o in self.ops
                   if not o.kind)


def _coll_bytes(op: Op) -> int:
    return op.result_bytes * (2 if op.kind == "all-reduce" else 1)


def collectives(ops: List[Op]) -> List[Op]:
    return [o for o in ops if o.kind]


def collective_bytes(ops: List[Op]) -> Dict[str, int]:
    """Per-collective-kind byte totals + 'total'."""
    out: Dict[str, int] = defaultdict(int)
    for o in collectives(ops):
        out[o.kind] += _coll_bytes(o)
    out["total"] = sum(out.values())
    return dict(out)


def collective_bytes_by_scope(ops: List[Op]) -> Dict[str, Dict[str, int]]:
    """``collective_bytes`` split into ``entry`` and ``body``."""
    return {s: collective_bytes([o for o in ops if o.scope == s])
            for s in ("entry", "body")}


def mesh_dims(ops: List[Op], mesh) -> Dict[str, List[str]]:
    """Each collective kind -> the mesh dims whose groups it ran over."""
    names = {mesh.get_group(i).group_name: n
             for i, n in enumerate(mesh.mesh_dim_names)}
    out: Dict[str, List[str]] = defaultdict(list)
    for o in collectives(ops):
        dim = names.get(o.group, o.group)
        if dim not in out[o.kind]:
            out[o.kind].append(dim)
    return dict(out)


def count_ops(ops: List[Op], opname: str) -> int:
    """How many recorded ops are ``opname`` (a collective kind such as
    "all-reduce", or an aten name such as "aten.mm")."""
    return sum(1 for o in ops if o.kind == opname
               or o.name == opname or o.name.startswith(opname + "."))


def dominant_collectives(ops: List[Op], top: int = 5):
    """Largest single collectives: (kind, result bytes, scope, local
    shapes)."""
    rows = [(o.kind, o.result_bytes, o.scope, o.shapes)
            for o in collectives(ops)]
    rows.sort(key=lambda r: -r[1])
    return rows[:top]

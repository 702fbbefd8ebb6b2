"""Multi-pod dry run: trace every (arch x shape x mesh) step on DTensors
over a fake 256- or 512-rank world, with no memory allocated, and record
the roofline's inputs (FLOPs, bytes, collective bytes, memory per device).
The counterpart of ``repro.launch.dryrun``.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
  python -m repro_torch.launch.dryrun --consolidate --arch tinyllama-1.1b
  python -m repro_torch.launch.dryrun --table     # the records as a table

Results go to experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.

The process opens the fake world itself (``launch.mesh.open_fake_world``)
before any mesh, so it runs as a process of its own.  Each step is traced
once under ``FakeTensorMode``: the inputs of ``launch.specs.input_specs``
become fake DTensors in their placements, and the step (forward, backward
and optimizer for ``train``) runs through the plain path
(``attn_impl="xla"``), as the reference's.  ``utils.collectives.Recorder``
sees each device's local ops, and the record keeps the reference's keys
where the port has a counterpart:

  * ``flops_per_device``: matmul FLOPs of the local ops (the shards'
    shapes, not the global product that a ``FlopCounterMode`` over
    DTensors counts);
  * ``bytes_accessed_per_device``: operand + result bytes of every local
    op that is not a view or a collective;
  * ``collective_bytes_per_device`` / ``_scoped``, ``top_collectives``;
  * ``memory_analysis``: ``argument_size_bytes`` and ``output_size_bytes``
    exact from the local shard shapes, ``temp_size_bytes`` the peak of
    live local storage the step allocated (its outputs included), and
    ``generated_code_size_bytes`` null: nothing is compiled;
  * ``trace_s``, host seconds, in place of ``lower_s`` / ``compile_s``.
  * for the ssm family ``wkv_form``: the WKV form traced (``WKV_FORM``),
    not the one the card or the plain path runs.

The world's device type is ``cpu``: DTensor then moves a shard between
two shardings by all-gather and a local chunk where an all-to-all would
serve, and records the all-gather.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch

from repro_torch.configs import canonical_names, get_config, get_shape
from repro_torch.launch import mesh as M
from repro_torch.launch.specs import (decode_seq_axis, input_specs,
                                      long_context_policy, param_shardings)
from repro_torch.models import sharding as shd
from repro_torch.models.config import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.models import model as _model
from repro_torch.models.rwkv import WKV_CHUNK
from repro_torch.models.model import forward
from repro_torch.serve.serve_step import make_serve_step
from repro_torch.train._tree import leaves
from repro_torch.train.optimizer import OptConfig, OptState
from repro_torch.train.train_step import make_train_step
from repro_torch.utils import collectives as coll

# What an ssm record's numbers are of: the WKV recurrence on DTensors is
# traced in its chunked form (``rwkv.wkv_chunked``), which neither the
# card (K2, K2b) nor the plain path (a sequential scan) runs.
WKV_FORM = (f"chunked: {WKV_CHUNK}-step chunks, a (B,H,N,C,C,D) float32 "
            f"decay tensor a layer, a log-step scan over the chunks")

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in shd.axis_sizes(mesh).values())


def _result_path(arch, shape, multi_pod, tag="", out_dir=None):
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    if tag:
        mesh_tag += f"__{tag}"
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_tag}.json")


def make_step_fn(cfg: ModelConfig, shape: ShapeConfig):
    if shape.kind == "train":
        return make_train_step(cfg, OptConfig())
    if shape.kind == "prefill":
        def prefill_fn(model, batch):
            logits, aux = forward(model, cfg, batch)
            return logits
        return prefill_fn
    return make_serve_step(cfg,
                           seq_sharded=decode_seq_axis(cfg, shape) is not None)


# ---------------------------------------------------------------------------
# fake DTensor inputs
# ---------------------------------------------------------------------------

def _local_bytes(t: torch.Tensor, spec, mesh) -> int:
    n = 1
    for s in shd.local_shape(tuple(t.shape), spec, mesh):
        n *= s
    return n * t.element_size()


def _fake(t: torch.Tensor, spec, mesh):
    """A fake DTensor of meta tensor ``t``'s shape and dtype in ``spec``'s
    placements, or with no mesh a plain fake tensor (to be called under
    ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    if mesh is None:
        return torch.empty(t.shape, dtype=t.dtype)
    local = torch.empty(shd.local_shape(tuple(t.shape), spec, mesh),
                        dtype=t.dtype)
    return DTensor.from_local(local, mesh, shd.to_placements(spec, mesh),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _materialize(x, spec, mesh):
    """``x`` (a meta model, meta tensor, OptState or dict of them) with
    every tensor a fake DTensor; the model's parameters are replaced in
    place."""
    if isinstance(x, torch.nn.Module):
        for name, p in list(x.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = x.get_submodule(owner) if owner else x
            setattr(mod, leaf, torch.nn.Parameter(
                _fake(p, spec[name], mesh), requires_grad=False))
        return x
    if isinstance(x, OptState):
        return OptState(*(_materialize(a, s, mesh) for a, s in zip(x, spec)))
    if isinstance(x, dict):
        return {k: _materialize(v, spec[k], mesh) for k, v in x.items()}
    return _fake(x, spec, mesh)


def argument_bytes(args, specs, mesh) -> int:
    """Local bytes of every argument, from the specs (the model's
    parameters by name)."""
    total = 0
    for a, s in zip(args, specs):
        if isinstance(a, torch.nn.Module):
            a = dict(a.named_parameters())
        if isinstance(a, dict):
            total += sum(_local_bytes(v, s[k], mesh) for k, v in a.items())
        elif isinstance(a, OptState):
            total += argument_bytes(list(a), list(s), mesh)
        else:
            total += _local_bytes(a, s, mesh)
    return total


def _out_bytes(out) -> int:
    if isinstance(out, torch.nn.Module):
        out = list(out.parameters())
    total = 0
    for t in leaves(out if isinstance(out, (list, tuple, dict)) else [out]):
        if isinstance(t, torch.nn.Module):
            total += _out_bytes(t)
        elif isinstance(t, torch.Tensor):
            local = t.to_local() if shd.is_dtensor(t) else t
            total += local.numel() * local.element_size()
    return total


@contextlib.contextmanager
def _block_scopes():
    """While the step is traced, each block on DTensors
    (``model._mesh_block``, the JAX package's scan body) is recorded in
    the ``body`` scope and the rest in ``entry``, the backward as the
    forward: a block's output switches the scope to ``body`` when its
    gradient arrives, the first block's input back to ``entry``."""
    inner = _model._mesh_block
    outputs = {}

    def scoped(remat, fn, seq_axis, blk, x, *rest):
        ref = outputs.get(id(x))
        if ref is None or ref() is not x:
            coll.mark_backward(x, "entry")
        with coll.scope("body"):
            out = inner(remat, fn, seq_axis, blk, x, *rest)
        y = out[0] if isinstance(out, tuple) else out
        coll.mark_backward(y, "body")
        outputs[id(y)] = weakref.ref(y)
        return out

    _model._mesh_block = scoped
    try:
        yield
    finally:
        _model._mesh_block = inner


def trace(fn, args, specs, mesh, call=None):
    """Run ``fn`` once on fake DTensors made from the meta ``args`` in
    ``specs``' placements (with ``mesh`` None, on plain fake tensors);
    returns (recorder, output bytes, seconds).  ``call(fn, dargs)`` makes
    the call (default ``fn(*dargs)``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.time()
    with FakeTensorMode():
        dargs = [_materialize(a, s, mesh) for a, s in zip(args, specs)]
        rec = coll.Recorder()
        with rec, implicit_replication(), _block_scopes():
            out = call(fn, dargs) if call else fn(*dargs)
        nbytes = _out_bytes(out)
    return rec, nbytes, time.time() - t0


def trace_unsharded(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Matmul FLOPs of the same step on plain fake tensors, no mesh: the
    global count that ``flops_per_device`` is held below."""
    args, specs, _ = input_specs(cfg, shape, {})
    rec, _, _ = trace(make_step_fn(cfg, shape), args, specs, None,
                      _call(shape))
    return rec.flops()


def _call(shape: ShapeConfig):
    """How the step is called: a decode step takes its position as a host
    integer (the last slot), not the args' 0-dim ``pos``."""
    if shape.kind != "decode":
        return None

    def call(fn, dargs):
        model, cache, token, _ = dargs
        return fn(model, cache, token, shape.seq_len - 1)
    return call


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def _variant(cfg: ModelConfig, shape_name: str, seq_parallel: bool):
    if not seq_parallel:
        return cfg
    # the "optimized" variant: sequence parallelism for train/prefill, an
    # fp8 KV cache for decode (the MoE buffer pins stay off, as in the
    # JAX package's)
    if shape_name in ("decode_32k", "long_500k"):
        return dataclasses.replace(cfg, kv_cache_dtype="float8_e4m3fn")
    return dataclasses.replace(cfg, seq_shard_axis="model")


def dryrun_one(arch: str, shape_name: str, multi_pod: bool = False,
               save: bool = True, seq_parallel: bool = False,
               tag: str = "", mesh=None, cfg: ModelConfig = None,
               shape: ShapeConfig = None,
               global_flops: bool = False, out_dir: str = None) -> dict:
    """Trace one step and return (and with ``save`` write) its record.
    ``mesh`` defaults to the production mesh over the open world; ``cfg``
    and ``shape`` default to the registered ones of ``arch`` and
    ``shape_name``.  ``global_flops`` adds ``flops_global``, the same
    step's count on plain tensors (``trace_unsharded``)."""
    cfg = _variant(cfg or get_config(arch), shape_name, seq_parallel)
    shape = shape or get_shape(shape_name)
    mesh = mesh or M.make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh),
           "kind": shape.kind, "status": "ok", "tag": tag}
    ok, reason = long_context_policy(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        if save:
            with open(_result_path(arch, shape_name, multi_pod, tag,
                                   out_dir), "w") as f:
                json.dump(rec, f, indent=1)
        return rec

    args, specs, meta = input_specs(cfg, shape, mesh)
    fn = make_step_fn(cfg, shape)
    call = _call(shape)
    arg_bytes = argument_bytes(args, specs, mesh)
    r, out_bytes, secs = trace(fn, args, specs, mesh, call)
    coll_b = coll.collective_bytes(r.ops)
    rec.update(
        chips=M.mesh_chip_count(mesh),
        trace_s=round(secs, 2),
        flops_per_device=float(r.flops()),
        bytes_accessed_per_device=float(r.bytes_accessed()),
        collective_bytes_per_device=coll_b,
        collective_bytes_scoped=coll.collective_bytes_by_scope(r.ops),
        top_collectives=[(k, int(b)) for k, b, _, _ in
                         coll.dominant_collectives(r.ops)],
        memory_analysis={
            "argument_size_bytes": int(arg_bytes),
            "output_size_bytes": int(out_bytes),
            "temp_size_bytes": int(r.peak_bytes),
            "generated_code_size_bytes": None,
        },
        params=cfg.param_count(),
        active_params=cfg.active_param_count(),
        tokens=shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1),
        seq_sharded=meta["seq_sharded"],
    )
    if cfg.family == "ssm":
        rec["wkv_form"] = WKV_FORM
    if global_flops:
        rec["flops_global"] = float(trace_unsharded(cfg, shape))
    print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}"
          f"{' ' + tag if tag else ''}: trace {secs:.1f}s, "
          f"flops/dev {rec['flops_per_device']:.3e}, "
          f"coll {coll_b.get('total', 0):.3e} B")
    print("  memory_analysis:", rec["memory_analysis"])
    if save:
        with open(_result_path(arch, shape_name, multi_pod, tag, out_dir),
                  "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def dryrun_consolidate(arch: str, save: bool = True, mesh=None,
                       cfg: ModelConfig = None, out_dir: str = None) -> dict:
    """Trace HadarE's pod-axis parameter consolidation on the 512-rank
    mesh: each parameter's two copies sharded over ``pod``, the average
    all-reduced over it."""
    from repro_torch.launch.specs import abstract_params
    from repro_torch.train.consolidate import (pod_consolidate,
                                               pod_consolidate_shardings)
    cfg = cfg or get_config(arch)
    mesh = mesh or M.make_production_mesh(multi_pod=True)
    model, params = abstract_params(cfg)
    ins, _ = pod_consolidate_shardings(param_shardings(model, mesh))
    stacked = {n: torch.empty((2,) + tuple(p.shape), dtype=p.dtype,
                              device="meta") for n, p in params.items()}
    steps = torch.empty((2,), dtype=torch.float32, device="meta")
    r, out_bytes, secs = trace(pod_consolidate, [stacked, steps],
                               [ins, shd.replicated(1)], mesh)
    coll_b = coll.collective_bytes(r.ops)
    rec = {"arch": arch, "shape": "consolidate", "mesh": _mesh_name(mesh),
           "kind": "consolidate", "status": "ok",
           "trace_s": round(secs, 2),
           "collective_bytes_per_device": coll_b,
           "collective_ops": coll.count_ops(r.ops, "all-reduce"),
           "collective_mesh_dims": coll.mesh_dims(r.ops, mesh),
           "output_size_bytes": int(out_bytes),
           "params": cfg.param_count()}
    print(f"[dryrun] consolidate {arch}: coll {coll_b.get('total', 0):.3e} B")
    if save:
        with open(_result_path(arch, "consolidate", True, "", out_dir),
                  "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def table(out_dir: str = None) -> str:
    """The recorded sweep as a markdown table, one row per (arch, shape):
    for each mesh the status (an ssm record's marked "chunked WKV", the
    form it traced), a device's argument + temp GB, its collective GB and
    the host seconds of the trace; then one row per consolidation."""
    out_dir = out_dir or OUT_DIR
    rows = ["| arch | shape | 16x16: status, args + temp GB, coll GB, s "
            "| 2x16x16: the same |", "| --- | --- | --- | --- |"]

    def cell(path):
        if not os.path.exists(path):
            return "missing"
        with open(path) as f:
            r = json.load(f)
        if r["status"] != "ok":
            return r["status"]
        m = r["memory_analysis"]
        form = " (chunked WKV)" if "wkv_form" in r else ""
        return (f"ok{form}, {m['argument_size_bytes'] / 1e9:.2f} + "
                f"{m['temp_size_bytes'] / 1e9:.2f}, "
                f"{r['collective_bytes_per_device']['total'] / 1e9:.2f}, "
                f"{r['trace_s']}")

    for arch in canonical_names():
        for shape in INPUT_SHAPES:
            rows.append(f"| {arch} | {shape} | " + " | ".join(
                cell(_result_path(arch, shape, mp, "", out_dir))
                for mp in (False, True)) + " |")
    for arch in canonical_names():
        path = _result_path(arch, "consolidate", True, "", out_dir)
        if os.path.exists(path):
            with open(path) as f:
                r = json.load(f)
            rows.append(f"| {arch} | consolidate | | {r['status']}, "
                        f"{r['collective_bytes_per_device']['total'] / 1e9:.2f}"
                        f" GB all-reduce over pod, {r['trace_s']} |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--consolidate", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--global-flops", action="store_true",
                    help="also trace each step unsharded (flops_global)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=None,
                    help="where the records go (default experiments/"
                    "dryrun_torch)")
    ap.add_argument("--table", action="store_true",
                    help="print the recorded sweep as a table and exit")
    args = ap.parse_args()
    if args.table:
        print(table(args.out_dir))
        return

    archs = canonical_names() if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    M.open_fake_world(512 if args.multi_pod or args.consolidate else 256)

    failures = []
    for arch in archs:
        if args.consolidate:
            dryrun_consolidate(arch, out_dir=args.out_dir)
            continue
        for shape in shapes:
            path = _result_path(arch, shape, args.multi_pod, args.tag,
                                args.out_dir)
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        continue
            try:
                dryrun_one(arch, shape, args.multi_pod,
                           seq_parallel=args.seq_parallel, tag=args.tag,
                           global_flops=args.global_flops,
                           out_dir=args.out_dir)
            except Exception as e:  # noqa: BLE001 (record and continue)
                traceback.print_exc()
                failures.append((arch, shape, str(e)[:200]))
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape,
                               "mesh": "2x16x16" if args.multi_pod
                               else "16x16",
                               "status": "error", "error": str(e)[:2000]},
                              f, indent=1)
    M.close_world()
    if failures:
        print("FAILURES:")
        for f_ in failures:
            print(" ", f_)
        raise SystemExit(1)
    print("dry-run sweep complete")


if __name__ == "__main__":
    main()

"""Diagnostics: the largest collectives of one (arch, shape) step, by
scope and with their local shapes, from the dry run's trace.  The
counterpart of ``repro.launch.diagnose``.

  PYTHONPATH=src python -m repro_torch.launch.diagnose --arch tinyllama-1.1b \\
      --shape train_4k [--multi-pod] [--top 12]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch.specs import input_specs
from repro_torch.utils import collectives as coll


def body_collectives(ops):
    """(scope, kind, bytes, local shapes, op) of every collective, the
    accounting convention's bytes (``utils.collectives``)."""
    return [(o.scope, o.kind, coll._coll_bytes(o), o.shapes, o.name)
            for o in coll.collectives(ops)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    cfg = get_config(args.arch)
    shape = get_shape(args.shape)
    M.open_fake_world(512 if args.multi_pod else 256)
    mesh = M.make_production_mesh(multi_pod=args.multi_pod)
    specs_args, specs, _ = input_specs(cfg, shape, mesh)
    rec, _, _ = D.trace(D.make_step_fn(cfg, shape), specs_args, specs, mesh,
                        D._call(shape))
    M.close_world()
    rows = body_collectives(rec.ops)
    rows.sort(key=lambda r: -r[2])
    print(f"== top collectives for {args.arch} x {args.shape} ==")
    for scope, kind, b, shapes, name in rows[:args.top]:
        print(f"[{scope}] {kind:18s} {b / 2**20:10.1f} MiB  {shapes}  {name}")


if __name__ == "__main__":
    main()

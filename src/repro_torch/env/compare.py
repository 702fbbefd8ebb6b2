"""Policy-comparison harness: one quality table over a shared trace.

The port's copy of ``repro.env.compare``.  The table's schema string is
the JAX package's (``repro.env.compare/v1``): it names the format, so a
table from either package validates with either validator.  The device
is explicit: ``run_one``/``compare`` take ``device=`` (None means the
card, and raises ``RuntimeError`` without CUDA unless the caller passes
``device="cpu"``); Hadar and HadarE build their scheduler on it.  Under
an observer (``repro_torch.obs``) each policy's run is a
``compare.policy`` wall span.

Runs a set of policies — Hadar, Gavel, HadarE, the classic baselines
(FCFS / SJF / SRTF, oracle and predicted, max-min share), Tiresias,
YARN-CS — over the *same* trace and cluster, and emits one table of
TTD / avg-JCT / GRU / CRU / goodput / evictions as JSON and text.

Every policy runs on a pristine clone of the job list
(``repro_torch.core.types.clone_jobs``), so no run can leak
``done_iters`` / ``evictions`` / ``lost_iters`` state into the next, and
each ``SimResult`` owns its own ``jobs`` (a later run cannot silently
mutate an earlier result's JCTs).

CLI::

    python -m repro_torch.env.compare --trace examples/traces/philly_mini.csv
    python -m repro_torch.env.compare --fig5 24 --seed 0 --mode event
    python -m repro_torch.env.compare --device cpu --fig5 8 \
        --policies fcfs,srtf --json out.json

``--policies`` narrows the zoo (comma-separated); ``--faults`` injects
a failure-trace CSV; ``--device`` (default ``cuda``) is where Hadar's
kernels run; ``REPRO_SANITIZE=1`` / ``REPRO_OBS=1`` pass through to the
engines.
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional

from repro_torch import obs as _obs
from repro_torch.core.types import Cluster, Job, clone_jobs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.env.baselines import (FCFSScheduler, MaxMinShareScheduler,
                                       SJFScheduler, SRTFScheduler)
from repro_torch.sim.metrics import SimResult

TABLE_SCHEMA = "repro.env.compare/v1"

# policies with no heterogeneity signal in their placement or ordering;
# the paper's comparison point for Hadar's TTD claim
BLIND_POLICIES = ("fcfs", "sjf", "sjf_pred", "srtf", "srtf_pred",
                  "maxmin", "yarn-cs")


def _make_hadar(device: DeviceLike = None):
    from repro_torch.core.hadar import HadarScheduler
    return HadarScheduler(device=device)


def _make_gavel():
    from repro_torch.core.schedulers import GavelScheduler
    return GavelScheduler()


def _make_tiresias():
    from repro_torch.core.schedulers import TiresiasScheduler
    return TiresiasScheduler()


def _make_yarn():
    from repro_torch.core.schedulers import YarnCSScheduler
    return YarnCSScheduler()


# name -> scheduler factory ("hadare" is special-cased: it is a
# simulation mode, not a Scheduler); every factory takes no argument but
# Hadar's, which takes the device its kernels run on
POLICIES: Dict[str, Callable[[], object]] = {
    "hadar": _make_hadar,
    "gavel": _make_gavel,
    "hadare": None,
    "fcfs": FCFSScheduler,
    "sjf": SJFScheduler,
    "sjf_pred": lambda: SJFScheduler(predicted=True),
    "srtf": SRTFScheduler,
    "srtf_pred": lambda: SRTFScheduler(predicted=True),
    "maxmin": MaxMinShareScheduler,
    "tiresias": _make_tiresias,
    "yarn-cs": _make_yarn,
}

DEFAULT_POLICIES = ("hadar", "gavel", "hadare", "fcfs", "sjf",
                    "sjf_pred", "srtf", "maxmin", "tiresias", "yarn-cs")


def _row(name: str, res: SimResult, mode: str) -> dict:
    return {
        "policy": name,
        "mode": mode,
        "ttd_hours": res.ttd_hours,
        "avg_jct_s": res.avg_jct(),
        "gru": res.avg_gru(),
        "cru": res.avg_cru(),
        "gru_overall": res.gru_overall(),
        "goodput": res.goodput(),
        "evictions": int(res.evictions),
        "restarts": int(sum(j.restarts for j in res.jobs)),
        "completed": sum(1 for j in res.jobs
                         if j.finish_time is not None),
        "n_jobs": len(res.jobs),
    }


def run_one(name: str, jobs: List[Job], cluster: Cluster,
            mode: str = "event", round_len: float = 360.0,
            faults=None, solver: Optional[str] = None,
            sanitize: Optional[bool] = None, device: DeviceLike = None,
            **kw) -> SimResult:
    """Run one policy on a pristine clone of ``jobs``.  ``kw`` is
    forwarded to the engine (``max_rounds`` / ``max_events`` / ...).
    ``device`` (None: the card) is where Hadar's kernels run; it is
    resolved here, for every policy, so none carries on without CUDA
    unless the caller asks for the CPU."""
    resolve_device(device)
    if name not in POLICIES:
        raise ValueError(f"unknown policy {name!r}; choose from "
                         f"{sorted(POLICIES)}")
    run_jobs = clone_jobs(jobs)
    ob = _obs.get()
    b_us = ob.begin() if ob.enabled else 0.0
    if name == "hadare":
        from repro_torch.sim.adapters import simulate_hadare
        res = simulate_hadare(run_jobs, cluster, round_len=round_len,
                              faults=faults, solver=solver,
                              sanitize=sanitize,
                              scheduler=_make_hadar(device),
                              **{k: v for k, v in kw.items()
                                 if k in ("max_rounds", "n_copies",
                                          "sync_overhead")})
    else:
        from repro_torch.sim.adapters import run as run_engine
        sched = _make_hadar(device) if name == "hadar" \
            else POLICIES[name]()
        res = run_engine(sched, run_jobs, cluster, mode=mode,
                         round_len=round_len, faults=faults, solver=solver,
                         sanitize=sanitize, **kw)
    if ob.enabled:
        ob.end("compare.policy", b_us, policy=name, mode=mode,
               ttd=res.total_seconds, evictions=res.evictions)
    return res


def compare(jobs: List[Job], cluster: Cluster,
            policies=DEFAULT_POLICIES, mode: str = "event",
            round_len: float = 360.0, faults=None,
            solver: Optional[str] = None,
            sanitize: Optional[bool] = None,
            trace_name: str = "custom", device: DeviceLike = None,
            **kw) -> dict:
    """Run every policy over the shared trace; return the quality table
    (see :data:`TABLE_SCHEMA` / :func:`validate_table`).  ``device`` as
    in :func:`run_one`."""
    resolve_device(device)
    rows = []
    for name in policies:
        res = run_one(name, jobs, cluster, mode=mode,
                      round_len=round_len, faults=faults, solver=solver,
                      sanitize=sanitize, device=device, **kw)
        eff_mode = "round" if name == "hadare" else mode
        rows.append(_row(name, res, eff_mode))
    return {
        "schema": TABLE_SCHEMA,
        "trace": trace_name,
        "n_jobs": len(jobs),
        "cluster": {"nodes": len(cluster.nodes),
                    "gpus": cluster.total_gpus(),
                    "types": list(cluster.gpu_types)},
        "mode": mode,
        "round_len": round_len,
        "faulted": faults is not None,
        "policies": rows,
    }


_ROW_FIELDS = {
    "policy": str, "mode": str, "ttd_hours": (int, float),
    "avg_jct_s": (int, float), "gru": (int, float), "cru": (int, float),
    "gru_overall": (int, float), "goodput": (int, float),
    "evictions": int, "restarts": int, "completed": int, "n_jobs": int,
}


def validate_table(doc: dict) -> List[str]:
    """Schema check for a compare table; returns a list of problems
    (empty = valid)."""
    probs: List[str] = []
    if not isinstance(doc, dict):
        return ["table is not an object"]
    if doc.get("schema") != TABLE_SCHEMA:
        probs.append(f"schema != {TABLE_SCHEMA}")
    for key in ("trace", "mode", "round_len", "policies", "cluster"):
        if key not in doc:
            probs.append(f"missing key {key!r}")
    rows = doc.get("policies")
    if not isinstance(rows, list) or not rows:
        probs.append("policies must be a non-empty list")
        return probs
    seen = set()
    for i, row in enumerate(rows):
        for field, typ in _ROW_FIELDS.items():
            if field not in row:
                probs.append(f"row {i}: missing {field!r}")
            elif not isinstance(row[field], typ) \
                    or isinstance(row[field], bool):
                probs.append(f"row {i}: {field!r} has type "
                             f"{type(row[field]).__name__}")
        if not probs:
            if not (0.0 <= row["gru"] <= 1.0 + 1e-9
                    and 0.0 <= row["cru"] <= 1.0 + 1e-9):
                probs.append(f"row {i}: GRU/CRU out of [0, 1]")
            if row["goodput"] > row["gru_overall"] + 1e-9:
                probs.append(f"row {i}: goodput exceeds overall GRU")
            if row["ttd_hours"] < 0.0 or row["avg_jct_s"] < 0.0:
                probs.append(f"row {i}: negative TTD/JCT")
        if row.get("policy") in seen:
            probs.append(f"row {i}: duplicate policy "
                         f"{row.get('policy')!r}")
        seen.add(row.get("policy"))
    return probs


def render_table(doc: dict) -> str:
    """Human-readable rendering of a compare table."""
    head = (f"policy comparison — trace={doc['trace']} "
            f"({doc['n_jobs']} jobs), cluster "
            f"{doc['cluster']['nodes']} nodes / "
            f"{doc['cluster']['gpus']} GPUs, mode={doc['mode']}, "
            f"round_len={doc['round_len']:.0f}s"
            + (", faults on" if doc.get("faulted") else ""))
    cols = ("policy", "ttd_h", "jct_s", "gru", "cru", "goodput",
            "evict", "restart", "done")
    lines = [head, "  ".join(f"{c:>9}" for c in cols)]
    for r in doc["policies"]:
        lines.append("  ".join([
            f"{r['policy']:>9}",
            f"{r['ttd_hours']:>9.2f}",
            f"{r['avg_jct_s']:>9.0f}",
            f"{r['gru']:>9.3f}",
            f"{r['cru']:>9.3f}",
            f"{r['goodput']:>9.3f}",
            f"{r['evictions']:>9d}",
            f"{r['restarts']:>9d}",
            f"{r['completed']:>9d}",
        ]))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="compare scheduling policies over a shared trace")
    ap.add_argument("--trace", type=str, default=None,
                    help="Philly/Helios-style CSV trace to replay")
    ap.add_argument("--fig5", type=int, default=None, metavar="N",
                    help="synthetic fig5 trace with N jobs instead of "
                         "a CSV")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival", choices=("start", "uniform", "bursty",
                                          "diurnal"), default="uniform",
                    help="arrival pattern for --fig5 traces")
    ap.add_argument("--mode", choices=("round", "event"),
                    default="event")
    ap.add_argument("--round-len", type=float, default=360.0)
    ap.add_argument("--policies", type=str, default=None,
                    help="comma-separated subset of "
                         + ",".join(POLICIES))
    ap.add_argument("--faults", type=str, default=None, metavar="CSV",
                    help="failure-trace CSV to inject")
    ap.add_argument("--solver", choices=("cuda", "numpy", "auto"),
                    default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="where Hadar's kernels run (cpu: their plain "
                         "versions)")
    ap.add_argument("--json", type=str, default=None, metavar="OUT",
                    help="also write the table as JSON")
    args = ap.parse_args(argv)

    resolve_device(args.device)
    from repro_torch.core.trace import philly_trace, simulation_cluster
    cluster = simulation_cluster()
    if args.trace is not None:
        from repro_torch.sim.replay import load_trace_csv
        jobs = load_trace_csv(args.trace, types=cluster.gpu_types)
        trace_name = args.trace
    else:
        n = args.fig5 if args.fig5 is not None else 24
        jobs = philly_trace(
            n_jobs=n, seed=args.seed,
            all_at_start=(args.arrival == "start"),
            arrival_pattern=(args.arrival if args.arrival in
                             ("bursty", "diurnal") else None))
        trace_name = f"fig5(n={n}, seed={args.seed}, {args.arrival})"
    faults = None
    if args.faults is not None:
        from repro_torch.sim.replay import load_fault_csv
        faults = load_fault_csv(args.faults)
    policies = (tuple(p.strip() for p in args.policies.split(",")
                      if p.strip())
                if args.policies else DEFAULT_POLICIES)
    doc = compare(jobs, cluster, policies=policies, mode=args.mode,
                  round_len=args.round_len, faults=faults,
                  solver=args.solver, trace_name=trace_name,
                  device=args.device)
    probs = validate_table(doc)
    if probs:
        raise SystemExit("invalid table: " + "; ".join(probs))
    print(render_table(doc))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

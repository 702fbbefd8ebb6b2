"""Real-trace replay: Philly/Helios-style CSV traces -> ``Job`` objects.

The port's copy of ``repro.sim.replay``.

Production DL traces (Microsoft Philly, SenseTime Helios) ship as CSVs
with one row per job: submit time, GPU demand, model/workload tag, and a
measured duration.  ``load_trace_csv`` maps such rows onto the same
``Job`` objects the synthetic generators produce, so any trace drives
both engines and every scheduler unchanged.

Column handling (header names are case-insensitive; common aliases from
the published trace schemas are accepted):

- ``job_id`` (``jobid``)                  — int, optional (row index).
  Non-numeric ids (Philly's ``application_...`` strings) are remapped
  to the row index; duplicate numeric ids are rejected (they would
  collide in the engines' job_id-keyed maps).
- ``arrival`` (``submit_time``,
  ``submitted_time``, ``timestamp``)      — seconds, float, or an ISO
  datetime (``2017-10-03 14:08:23``); datetime traces are shifted so
  the earliest submission is t=0.
- ``n_workers`` (``num_gpus``, ``gpu_num``,
  ``worker_count``)                       — GPU demand W_j; rows with 0
  GPUs (Philly's CPU-only jobs) are skipped — no scheduler places them.
- ``model``                               — key into the Gavel-style
  throughput table when no explicit ``tp_*`` columns are present.
- ``tp_<type>``                           — iterations/sec per device of
  ``<type>``; overrides the table.  When ``types`` is passed (pass the
  target cluster's ``gpu_types`` — type-blind schedulers may hand a job
  any of them), every requested type must be rated or the row is
  rejected.
- ``epochs`` + ``iters_per_epoch``        — explicit work volume, or
- ``duration_hours`` (``duration``,
  seconds)                                — calibrated to iterations on
  the job's median device type, exactly like the synthetic generator.
- ``size``                                — S/M/L/XL class (default M).
- ``restart_penalty``                     — seconds; empty uses the
  engine default (or derive per size via ``hetero_restarts=True``).

``save_trace_csv`` writes the canonical superset so load(save(jobs))
round-trips losslessly.

Failure traces
--------------
``load_fault_csv`` / ``save_fault_csv`` handle the companion
failure-trace schema, one row per outage window:

- ``node_id``       — int, required; validated against the cluster when
  one is passed (unknown nodes rejected).
- ``fail_time``     — seconds, required, >= 0.
- ``recover_time``  — seconds, > fail_time; **empty means the node
  never recovers** (serialized back as empty).
- ``kind``          — optional, ``fail`` (default) or ``spot``.

Validation rides on :class:`repro_torch.sim.faults.FailureTrace`:
overlapping windows on one node, inverted windows, and unknown kinds are
rejected with the offending window named — the same rigor as job rows.
"""
from __future__ import annotations

import csv
import datetime as _dt
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.trace import (THROUGHPUT_TABLE, calibrate_iters,
                                    restart_penalty_for, restrict)
from repro_torch.core.types import Cluster, Job
from repro_torch.sim.faults import FailureTrace, FaultWindow, KIND_FAIL

_ALIASES = {
    "job_id": ("job_id", "jobid"),
    "arrival": ("arrival", "submit_time", "submitted_time", "timestamp"),
    "n_workers": ("n_workers", "num_gpus", "gpu_num", "worker_count"),
    "duration_hours": ("duration_hours",),
    "duration": ("duration",),
}


def _get(row: Dict[str, str], field: str) -> Optional[str]:
    for name in _ALIASES.get(field, (field,)):
        v = row.get(name)
        if v is not None and v.strip() != "":
            return v.strip()
    return None


def _parse_arrival(raw: Optional[str], idx: int) -> Tuple[float, bool]:
    """Seconds-as-float, or an ISO datetime -> epoch seconds (flagged so
    the caller can rebase the trace to t=0)."""
    if raw is None:
        return 0.0, False
    try:
        return float(raw), False
    except ValueError:
        pass
    try:
        return _dt.datetime.fromisoformat(raw).timestamp(), True
    except ValueError:
        raise ValueError(f"row {idx}: unparseable arrival {raw!r}")


def load_trace_csv(path: str, types: Optional[List[str]] = None,
                   hetero_restarts: bool = False) -> List[Job]:
    """Load a Philly/Helios-style CSV trace as a list of ``Job``s."""
    jobs: List[Job] = []
    any_datetime = False
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            return jobs
        lower = {name: name.strip().lower() for name in reader.fieldnames}
        for idx, raw in enumerate(reader):
            row = {lower[k]: (v or "") for k, v in raw.items()
                   if k is not None}
            n_workers = int(float(_get(row, "n_workers") or 1))
            if n_workers <= 0:
                continue        # CPU-only rows (Philly num_gpus=0)
            tp = {k[3:]: float(v) for k, v in row.items()
                  if k.startswith("tp_") and v.strip() != ""}
            model = _get(row, "model") or "unknown"
            if not tp:
                if model not in THROUGHPUT_TABLE:
                    raise ValueError(
                        f"row {idx}: no tp_* columns and model {model!r} "
                        f"not in the throughput table")
                tp = (restrict(model, types) if types
                      else dict(THROUGHPUT_TABLE[model]))
            elif types:
                tp = {r: x for r, x in tp.items() if r in types}
            # the engines assume every job rates every schedulable type:
            # type-blind schedulers (YARN-CS) may hand a job any device,
            # and bottleneck_rate KeyErrors on an unrated one; a job with
            # no rated types can never run and would hang the simulation
            missing = set(types or ()) - set(tp)
            if missing or not tp:
                raise ValueError(
                    f"row {idx}: throughput covers {sorted(tp)} but the "
                    f"requested types are {sorted(types or ())} — every "
                    f"requested type needs a rate (tp_<type> column or a "
                    f"known model)")

            epochs = _get(row, "epochs")
            ipe = _get(row, "iters_per_epoch")
            if epochs is not None and ipe is not None:
                epochs_i, ipe_i = int(float(epochs)), int(float(ipe))
            else:
                dur_h = _get(row, "duration_hours")
                dur_s = _get(row, "duration")
                if dur_h is not None:
                    gpu_hours = float(dur_h)
                elif dur_s is not None:
                    gpu_hours = float(dur_s) / 3600.0
                else:
                    raise ValueError(
                        f"row {idx}: need epochs+iters_per_epoch or a "
                        f"duration column")
                # same median-type calibration as the synthetic generator
                epochs_i, ipe_i = calibrate_iters(gpu_hours, tp)

            size = _get(row, "size") or "M"
            pen = _get(row, "restart_penalty")
            raw_id = _get(row, "job_id")
            try:
                job_id = int(float(raw_id)) if raw_id is not None else idx
            except ValueError:          # Philly 'application_...' strings
                job_id = idx
            arrival, is_datetime = _parse_arrival(_get(row, "arrival"), idx)
            any_datetime = any_datetime or is_datetime
            job = Job(
                job_id=job_id,
                arrival=arrival,
                n_workers=n_workers,
                epochs=epochs_i,
                iters_per_epoch=ipe_i,
                throughput=tp,
                model=model,
                size=size,
                restart_penalty=float(pen) if pen is not None else None)
            if hetero_restarts and job.restart_penalty is None:
                job.restart_penalty = restart_penalty_for(size)
            jobs.append(job)
    if any_datetime and jobs:
        t0 = min(j.arrival for j in jobs)
        for j in jobs:
            j.arrival -= t0
    seen: Dict[int, int] = {}
    for i, j in enumerate(jobs):
        if j.job_id in seen:
            raise ValueError(
                f"duplicate job_id {j.job_id} (rows {seen[j.job_id]} and "
                f"{i}): ids key the engines' allocation maps")
        seen[j.job_id] = i
    return jobs


def save_trace_csv(jobs: List[Job], path: str) -> None:
    """Write ``jobs`` in the canonical schema (lossless round-trip)."""
    tp_types: List[str] = []
    for j in jobs:
        for r in j.throughput:
            if r not in tp_types:
                tp_types.append(r)
    fields = (["job_id", "arrival", "n_workers", "epochs",
               "iters_per_epoch", "model", "size", "restart_penalty"]
              + [f"tp_{r}" for r in tp_types])
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for j in jobs:
            row = {
                "job_id": j.job_id,
                "arrival": repr(j.arrival),
                "n_workers": j.n_workers,
                "epochs": j.epochs,
                "iters_per_epoch": j.iters_per_epoch,
                "model": j.model,
                "size": j.size,
                "restart_penalty": ("" if j.restart_penalty is None
                                    else repr(j.restart_penalty)),
            }
            for r in tp_types:
                if r in j.throughput:
                    row[f"tp_{r}"] = repr(j.throughput[r])
            w.writerow(row)


# ---------------------------------------------------------------------------
# failure traces
# ---------------------------------------------------------------------------

FAULT_FIELDS = ["node_id", "fail_time", "recover_time", "kind"]


def load_fault_csv(path: str,
                   cluster: Optional[Cluster] = None) -> FailureTrace:
    """Load a failure-trace CSV (see module docstring for the schema).

    Pass the target ``cluster`` to reject windows naming unknown nodes
    at load time rather than at the engine boundary."""
    windows: List[FaultWindow] = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            return FailureTrace([], cluster)
        lower = {name: name.strip().lower() for name in reader.fieldnames}
        for idx, raw in enumerate(reader):
            row = {lower[k]: (v or "").strip() for k, v in raw.items()
                   if k is not None}
            node_raw = row.get("node_id", "")
            if node_raw == "":
                raise ValueError(f"fault row {idx}: missing node_id")
            fail_raw = row.get("fail_time", "")
            if fail_raw == "":
                raise ValueError(f"fault row {idx}: missing fail_time")
            rec_raw = row.get("recover_time", "")
            try:
                node_id = int(float(node_raw))
                fail_t = float(fail_raw)
                rec_t = math.inf if rec_raw == "" else float(rec_raw)
            except ValueError:
                raise ValueError(
                    f"fault row {idx}: unparseable numeric field in "
                    f"{dict(row)!r}")
            kind = row.get("kind", "") or KIND_FAIL
            windows.append(FaultWindow(node_id, fail_t, rec_t, kind))
    # FailureTrace validation: overlap, inversion, unknown node/kind
    return FailureTrace(windows, cluster)


def save_fault_csv(trace: FailureTrace, path: str) -> None:
    """Write a failure trace in the canonical schema; ``inf`` recovery
    serializes as an empty cell so load(save(trace)) round-trips."""
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FAULT_FIELDS)
        w.writeheader()
        for win in trace:
            w.writerow({
                "node_id": win.node_id,
                "fail_time": repr(win.fail_time),
                "recover_time": ("" if math.isinf(win.recover_time)
                                 else repr(win.recover_time)),
                "kind": win.kind,
            })

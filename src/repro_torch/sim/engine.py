"""The round-quantized simulation engine (paper §IV).

The port's copy of ``simulate_rounds`` from ``repro.sim.engine``, without
fault injection and the observability and sanitizer hooks (the JAX
package's event engine and fault model are not ported yet).  Every
``round_len`` seconds the scheduler is consulted; steady rounds under a
``stable_when_idle`` scheduler fast-forward to the next arrival or
completion with byte-identical metrics.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import time
from typing import List, Optional, Set

from repro_torch.core.types import Alloc, Cluster, Job, alloc_nodes, \
    alloc_size
from repro_torch.sim.metrics import RoundRecord, SimResult

RESTART_PENALTY = 10.0  # seconds per allocation change (paper §IV)


def _alloc_equal(a: Optional[Alloc], b: Optional[Alloc]) -> bool:
    return (a or {}) == (b or {})


def _job_penalty(job: Job, default: float) -> float:
    return default if job.restart_penalty is None else job.restart_penalty


def _reset_jobs(jobs: List[Job]) -> None:
    """Reset every simulator-owned mutable field so repeated runs on the
    same job list start clean."""
    for j in jobs:
        j.done_iters = 0.0
        j.finish_time = None
        j.attained_service = 0.0
        j.alloc = None
        j.restarts = 0
        j.evictions = 0
        j.lost_iters = 0.0


def _apply_solver(scheduler, solver: Optional[str]) -> None:
    """Engine-level pricing-backend override: forwarded to schedulers
    that expose a ``solver`` flag; the name is validated here, at the
    engine's entry."""
    if solver is not None:
        from repro_torch.core.batch_solver import check_solver
        check_solver(solver)
        if hasattr(scheduler, "solver"):
            scheduler.solver = solver


def simulate_rounds(scheduler, jobs: List[Job], cluster: Cluster,
                    round_len: float = 360.0, max_rounds: int = 20000,
                    restart_penalty: float = RESTART_PENALTY,
                    solver: Optional[str] = None) -> SimResult:
    """Round-based simulation; O(events) on sparse traces via steady
    fast-forward.  ``solver`` ("cuda" | "numpy" | "auto") overrides the
    scheduler's pricing backend; decisions are backend-independent."""
    _apply_solver(scheduler, solver)
    jobs = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    _reset_jobs(jobs)
    total_gpus = cluster.total_gpus()
    n_nodes = len(cluster.nodes)
    busy_total = avail_total = 0.0
    arrivals = [j.arrival for j in jobs]          # sorted with jobs
    rounds: List[RoundRecord] = []
    t = 0.0
    rnd = 0
    while rnd < max_rounds:
        if all(j.is_done() for j in jobs):
            break
        avail_gpus, avail_nodes = total_gpus, n_nodes
        if cluster.nodes:
            t0 = time.perf_counter()
            desired = scheduler.schedule(t, round_len, jobs, cluster)
            sched_s = time.perf_counter() - t0
        else:
            desired = {}            # no nodes: nothing schedulable
            sched_s = 0.0

        changed = 0
        busy_gpu_time = 0.0
        busy_nodes: Set[int] = set()
        any_completed = False
        for j in jobs:
            new = desired.get(j.job_id)
            if j.is_done():
                j.alloc = None
                continue
            if not _alloc_equal(j.alloc, new):
                if j.alloc is not None or new is not None:
                    changed += 1
                if new is not None and j.alloc is not None:
                    j.restarts += 1
                penalty = _job_penalty(j, restart_penalty) if new else 0.0
            else:
                penalty = 0.0
            j.alloc = new
            if not new:
                continue
            rate = j.bottleneck_rate(new)
            w = alloc_size(new)
            eff = max(0.0, round_len - penalty)
            iters_possible = rate * w * eff
            need = j.remaining_iters
            if iters_possible >= need and rate * w > 0:
                used = penalty + need / (rate * w)
                j.done_iters = j.total_iters
                j.finish_time = t + used
                any_completed = True
                busy_gpu_time += w * used
                busy_nodes.update(alloc_nodes(new))
                j.attained_service += w * used
            else:
                j.done_iters += iters_possible
                busy_gpu_time += w * round_len
                busy_nodes.update(alloc_nodes(new))
                j.attained_service += w * round_len

        if any_completed and hasattr(scheduler, "note_completion"):
            scheduler.note_completion()

        n_active = sum(1 for j in jobs
                       if not j.is_done() and j.arrival <= t)
        n_running = sum(1 for j in jobs if j.alloc and not j.is_done())
        rounds.append(RoundRecord(
            t=t,
            gru=(busy_gpu_time / (avail_gpus * round_len)
                 if avail_gpus > 0 else 0.0),
            cru=(len(busy_nodes) / avail_nodes if avail_nodes > 0
                 else 0.0),
            running=n_running,
            waiting=n_active - n_running,
            changed=changed,
            sched_seconds=sched_s))
        busy_total += busy_gpu_time
        avail_total += avail_gpus * round_len
        t += round_len
        rnd += 1

        # ---- event-aware fast-forward --------------------------------
        # A steady round (no completion, no change) under a stable
        # scheduler with nobody waiting repeats verbatim until the next
        # arrival or completion; replay it in bulk.
        if (not getattr(scheduler, "stable_when_idle", False)
                or any_completed or changed):
            continue
        running_jobs = [j for j in jobs if j.alloc and not j.is_done()]
        n_active_next = sum(1 for j in jobs
                            if not j.is_done() and j.arrival <= t)
        if not running_jobs or len(running_jobs) != n_active_next:
            continue
        # rounds until the earliest completion (that round runs normally)
        k_comp = min(
            math.ceil(j.remaining_iters
                      / max(j.bottleneck_rate(j.alloc) * alloc_size(j.alloc)
                            * round_len, 1e-12))
            for j in running_jobs)
        # rounds until the next arrival becomes active
        i_arr = bisect.bisect_right(arrivals, t)
        k_arr = (math.ceil((arrivals[i_arr] - t) / round_len)
                 if i_arr < len(arrivals) else k_comp)
        skip = min(k_comp - 1, k_arr, max_rounds - rnd)
        # float safety: ceil() can under-count by one ulp; the bulk
        # progress below must leave every job strictly unfinished, or the
        # completion round (finish_time, note_completion) would be skipped
        while skip > 0 and any(
                j.done_iters + j.bottleneck_rate(j.alloc)
                * alloc_size(j.alloc) * round_len * skip
                >= j.total_iters - 1e-9
                for j in running_jobs):
            skip -= 1
        if skip <= 0:
            continue
        for j in running_jobs:
            w = alloc_size(j.alloc)
            j.done_iters += j.bottleneck_rate(j.alloc) * w * round_len * skip
            j.attained_service += w * round_len * skip
        steady = rounds[-1]
        for i in range(skip):
            rounds.append(dataclasses.replace(
                steady, t=t + i * round_len, sched_seconds=0.0))
        busy_total += busy_gpu_time * skip
        avail_total += avail_gpus * round_len * skip
        t += skip * round_len
        rnd += skip

    total = max((j.finish_time or t) for j in jobs) if jobs else 0.0
    return SimResult(scheduler.name, rounds, jobs, total,
                     gpu_seconds_busy=busy_total,
                     gpu_seconds_avail=avail_total)

"""Classic scheduling baselines (Gavel's comparison set, [10] §2):
FCFS, SJF, SRTF — with oracle or predicted durations — and a
heterogeneity-blind max-min share policy.

The port's copy of ``repro.env.baselines``: host Python and NumPy, as
there.  Every baseline implements the port's
``repro_torch.core.schedulers.Scheduler`` protocol, so each is usable
three ways with identical decisions: as a policy over
:class:`repro_torch.env.ClusterSchedulingEnv` (via ``run_policy``), and
directly in both simulation engines (``simulate_rounds`` /
``simulate_events``).

All four are *heterogeneity-blind*: a GPU is a GPU.  Gang placement
ignores device types entirely (``_blind_gang`` consolidates on the
fullest (node, type) cells the job can run on at all), so a gang
spanning V100s and K80s pays the Eq. 1b bottleneck rate of its slowest
device — exactly the behaviour the paper's heterogeneity-aware
schedulers exploit.  Duration estimates are equally blind: seconds at
the job's *mean* positive throughput, not its best.

``predicted=True`` (SJF/SRTF) multiplies each job's duration estimate
by deterministic per-job lognormal noise (the Helios/2109.01313
misprediction regime): same job id + seed -> same misprediction, so
runs stay bitwise-reproducible.

Allocations are sticky where the discipline allows: a job selected to
keep running keeps its exact allocation, which both avoids gratuitous
restart penalties and makes ``stable_when_idle`` provable (when every
active job is allocated and nothing arrived or completed, the returned
map is identical, so the engines may fast-forward).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from repro_torch.core.schedulers import Scheduler, _free_pool, _take
from repro_torch.core.types import Alloc, Cluster, Job


def _blind_gang(cluster: Cluster, taken: Dict, job: Job) \
        -> Optional[Alloc]:
    """Type-blind gang allocation: ``n_workers`` devices from the
    fullest eligible (node, type) cells (eligible = the job's
    throughput there is positive — a zero-throughput device cannot run
    it at all, which is infeasibility, not heterogeneity awareness).
    Ties break on (node_id, gpu_type) so decisions replay identically.
    """
    free = _free_pool(cluster, taken)
    cells = [((h, r), c) for (h, r), c in free.items()
             if c > 0 and job.throughput.get(r, 0.0) > 0.0]
    if sum(c for _, c in cells) < job.n_workers:
        return None
    cells.sort(key=lambda kv: (-kv[1], kv[0][0], kv[0][1]))
    alloc: Alloc = {}
    need = job.n_workers
    for (h, r), c in cells:
        take = min(need, c)
        alloc[(h, r)] = take
        need -= take
        if need == 0:
            return alloc
    return None


def _fits(cluster: Cluster, taken: Dict, alloc: Alloc) -> bool:
    """True iff ``alloc`` still fits the cluster view net of ``taken``
    (used to keep a running job's allocation sticky)."""
    free = _free_pool(cluster, taken)
    return all(free.get(k, 0) >= c for k, c in alloc.items())


def _can_ever_fit(cluster: Cluster, job: Job) -> bool:
    """Whole-cluster feasibility: without this guard a job demanding
    more devices than exist would head-of-line-block FCFS forever."""
    cap = 0
    for n in cluster.nodes:
        for r, c in n.gpus.items():
            if job.throughput.get(r, 0.0) > 0.0:
                cap += c
    return cap >= job.n_workers


def _duration_noise(job_id: int, seed: int, sigma: float) -> float:
    """Deterministic per-job misprediction factor: lognormal(0, sigma)
    drawn from a stream keyed on (seed, job_id)."""
    rng = np.random.RandomState((seed * 1000003 + job_id) % (2 ** 32))
    return float(math.exp(sigma * rng.standard_normal()))


class _DurationEstimator:
    """Heterogeneity-blind duration model shared by SJF and SRTF:
    seconds at W * mean positive throughput, optionally scaled by the
    job's fixed misprediction factor."""

    def __init__(self, predicted: bool, sigma: float, seed: int):
        self.predicted = bool(predicted)
        self.sigma = float(sigma)
        self.seed = int(seed)
        self._noise: Dict[int, float] = {}

    def factor(self, job: Job) -> float:
        if not self.predicted:
            return 1.0
        f = self._noise.get(job.job_id)
        if f is None:
            f = _duration_noise(job.job_id, self.seed, self.sigma)
            self._noise[job.job_id] = f
        return f

    def total_seconds(self, job: Job) -> float:
        tps = [x for x in job.throughput.values() if x > 0.0]
        mean_tp = sum(tps) / len(tps) if tps else 0.0
        if mean_tp <= 0.0 or job.n_workers <= 0:
            return float("inf")
        return (job.total_iters / (job.n_workers * mean_tp)
                * self.factor(job))

    def remaining_seconds(self, job: Job) -> float:
        tps = [x for x in job.throughput.values() if x > 0.0]
        mean_tp = sum(tps) / len(tps) if tps else 0.0
        if mean_tp <= 0.0 or job.n_workers <= 0:
            return float("inf")
        return (job.remaining_iters / (job.n_workers * mean_tp)
                * self.factor(job))


class FCFSScheduler(Scheduler):
    """First-come-first-served, non-preemptive, strict FIFO: the head
    of the queue blocks everyone behind it until it fits (jobs that can
    *never* fit the cluster are skipped rather than wedging the queue —
    see ``_can_ever_fit``)."""

    name = "fcfs"
    preemptive = False
    stable_when_idle = True

    def schedule(self, now, round_len, jobs, cluster):
        active = [j for j in jobs if not j.is_done() and j.arrival <= now]
        taken: Dict = {}
        out: Dict[int, Alloc] = {}
        for j in active:                    # non-preemptive: keep running
            if j.alloc:
                out[j.job_id] = j.alloc
                _take(taken, j.alloc)
        for j in sorted(active, key=lambda j: (j.arrival, j.job_id)):
            if j.job_id in out or j.n_workers <= 0:
                continue
            if not _can_ever_fit(cluster, j):
                continue
            alloc = _blind_gang(cluster, taken, j)
            if alloc is None:
                break                       # strict FIFO: head blocks
            out[j.job_id] = alloc
            _take(taken, alloc)
        return out


class SJFScheduler(Scheduler):
    """Shortest-job-first, non-preemptive: running jobs keep their
    allocation; waiting jobs are admitted shortest-estimated-duration
    first (no head-of-line blocking — an unfittable short job is
    skipped this round)."""

    name = "sjf"
    preemptive = False
    stable_when_idle = True

    def __init__(self, predicted: bool = False, sigma: float = 0.35,
                 seed: int = 0):
        self.est = _DurationEstimator(predicted, sigma, seed)
        if predicted:
            self.name = "sjf_pred"

    def schedule(self, now, round_len, jobs, cluster):
        active = [j for j in jobs if not j.is_done() and j.arrival <= now]
        taken: Dict = {}
        out: Dict[int, Alloc] = {}
        for j in active:
            if j.alloc:
                out[j.job_id] = j.alloc
                _take(taken, j.alloc)
        waiting = [j for j in active
                   if j.job_id not in out and j.n_workers > 0]
        waiting.sort(key=lambda j: (self.est.total_seconds(j),
                                    j.arrival, j.job_id))
        for j in waiting:
            alloc = _blind_gang(cluster, taken, j)
            if alloc is not None:
                out[j.job_id] = alloc
                _take(taken, alloc)
        return out


class SRTFScheduler(Scheduler):
    """Shortest-remaining-time-first, preemptive: every consult ranks
    all active jobs by estimated remaining duration and admits them in
    order, keeping a job's existing allocation when it still fits
    (sticky) and allocating fresh otherwise; jobs that don't make the
    cut are preempted (idled) this round."""

    name = "srtf"
    preemptive = True
    stable_when_idle = True

    def __init__(self, predicted: bool = False, sigma: float = 0.35,
                 seed: int = 0):
        self.est = _DurationEstimator(predicted, sigma, seed)
        if predicted:
            self.name = "srtf_pred"

    def _order(self, active):
        return sorted(active, key=lambda j: (self.est.remaining_seconds(j),
                                             j.arrival, j.job_id))

    def schedule(self, now, round_len, jobs, cluster):
        active = [j for j in jobs if not j.is_done() and j.arrival <= now
                  and j.n_workers > 0]
        taken: Dict = {}
        out: Dict[int, Alloc] = {}
        for j in self._order(active):
            if j.alloc and _fits(cluster, taken, j.alloc):
                out[j.job_id] = j.alloc     # sticky: no gratuitous restart
                _take(taken, j.alloc)
                continue
            alloc = _blind_gang(cluster, taken, j)
            if alloc is not None:
                out[j.job_id] = alloc
                _take(taken, alloc)
        return out


class MaxMinShareScheduler(SRTFScheduler):
    """Heterogeneity-blind max-min share: active jobs are served in
    order of least attained GPU-seconds (max-min fairness on
    accumulated service), full gangs, sticky allocations.  The
    admission loop is SRTF's; only the ranking differs."""

    name = "maxmin"
    preemptive = True
    stable_when_idle = True

    def __init__(self):
        super().__init__(predicted=False)
        self.name = "maxmin"

    def _order(self, active):
        return sorted(active, key=lambda j: (j.attained_service,
                                             j.arrival, j.job_id))


__all__ = [
    "FCFSScheduler",
    "SJFScheduler",
    "SRTFScheduler",
    "MaxMinShareScheduler",
]

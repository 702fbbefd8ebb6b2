"""Simulation metrics: per-round / per-interval records and results.

The port's copy of ``repro.sim.metrics``, without the observability and
sanitizer hooks.  The continuous-time engine records *intervals* — the
spans between consecutive events — instead of fixed rounds;
:class:`IntervalRecord` adds the interval length ``dt`` and
:class:`EventSimResult` reweights GRU/CRU by time so sparse traces
(where intervals have wildly different lengths) are averaged fairly.

:class:`MetricsRecorder` is the incremental recorder used by
``simulate_events``: the engine reports each closed interval once, with
the busy GPU-time and busy nodes accrued over it, and the recorder
derives GRU/CRU on the fly — no post-hoc pass over the trace is
needed.  :func:`result_fields` is the port's own: every field of a
result but host time, the form in which two runs are held equal.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Set

from repro_torch.core.types import Job


@dataclasses.dataclass
class RoundRecord:
    t: float
    gru: float                 # GPU-level utilization this round
    cru: float                 # node-level utilization this round
    running: int
    waiting: int
    changed: int
    sched_seconds: float


@dataclasses.dataclass
class IntervalRecord(RoundRecord):
    """A continuous-time inter-event interval [t, t + dt)."""
    dt: float = 0.0


@dataclasses.dataclass
class SimResult:
    scheduler: str
    rounds: List[RoundRecord]
    jobs: List[Job]
    total_seconds: float       # TTD
    # --- goodput accounting (fault realism) ---
    # busy: GPU-seconds held by allocated jobs; avail: GPU-seconds of
    # *live* capacity (down nodes excluded); lost: GPU-seconds wasted to
    # faults — rolled-back progress plus fault-restart penalty time.
    # Ordinary (scheduler-chosen) restart penalties count as busy in
    # both GRU and goodput, so goodput == gru_overall exactly when no
    # fault eviction lost anything.
    gpu_seconds_busy: float = 0.0
    gpu_seconds_avail: float = 0.0
    gpu_seconds_lost: float = 0.0
    evictions: int = 0

    @property
    def ttd_hours(self) -> float:
        return self.total_seconds / 3600.0

    def gru_overall(self) -> float:
        """Whole-run GPU utilization: busy / available GPU-seconds."""
        if self.gpu_seconds_avail <= 0.0:
            return 0.0
        return self.gpu_seconds_busy / self.gpu_seconds_avail

    def goodput(self) -> float:
        """Useful progress-seconds / available GPU-seconds: the busy
        time minus work rolled back and penalties paid because of
        faults.  Always <= gru_overall(); strictly below it iff a
        fault eviction cost something."""
        if self.gpu_seconds_avail <= 0.0:
            return 0.0
        useful = max(0.0, self.gpu_seconds_busy - self.gpu_seconds_lost)
        return useful / self.gpu_seconds_avail

    def avg_jct(self) -> float:
        done = [j.finish_time - j.arrival for j in self.jobs
                if j.finish_time is not None]
        return sum(done) / max(1, len(done))

    def max_min_jct(self):
        done = [j.finish_time - j.arrival for j in self.jobs
                if j.finish_time is not None]
        return (max(done), min(done)) if done else (0.0, 0.0)

    def avg_gru(self) -> float:
        # average over rounds with any demand
        rs = [r.gru for r in self.rounds if r.running + r.waiting > 0]
        return sum(rs) / max(1, len(rs))

    def avg_cru(self) -> float:
        rs = [r.cru for r in self.rounds if r.running + r.waiting > 0]
        return sum(rs) / max(1, len(rs))

    def completion_cdf(self):
        ts = sorted(j.finish_time for j in self.jobs
                    if j.finish_time is not None)
        return [(t, (i + 1) / len(self.jobs)) for i, t in enumerate(ts)]

    def median_completion(self) -> float:
        cdf = self.completion_cdf()
        for t, frac in cdf:
            if frac >= 0.5:
                return t
        return self.total_seconds

    def changed_round_frac(self) -> float:
        rs = [r for r in self.rounds if r.running > 0]
        return (sum(1 for r in rs if r.changed > 0) / max(1, len(rs)))


@dataclasses.dataclass
class EventSimResult(SimResult):
    """Continuous-time result: ``rounds`` holds IntervalRecords; GRU/CRU
    averages are weighted by interval length, not per record."""
    n_events: int = 0
    sched_calls: int = 0

    def avg_gru(self) -> float:
        num = den = 0.0
        for r in self.rounds:
            if r.running + r.waiting > 0 and r.dt > 0:
                num += r.gru * r.dt
                den += r.dt
        return num / den if den > 0 else 0.0

    def avg_cru(self) -> float:
        num = den = 0.0
        for r in self.rounds:
            if r.running + r.waiting > 0 and r.dt > 0:
                num += r.cru * r.dt
                den += r.dt
        return num / den if den > 0 else 0.0

    def changed_round_frac(self) -> float:
        num = den = 0.0
        for r in self.rounds:
            if r.running > 0 and r.dt > 0:
                num += r.dt * (1.0 if r.changed > 0 else 0.0)
                den += r.dt
        return num / den if den > 0 else 0.0


class MetricsRecorder:
    """Incremental interval recorder for the event engine."""

    def __init__(self, total_gpus: int, n_nodes: int):
        self.total_gpus = max(1, total_gpus)
        self.n_nodes = max(1, n_nodes)
        # live (fault-aware) capacity; set_capacity updates it as nodes
        # fail and recover.  Starts at the full cluster.
        self.avail_gpus = self.total_gpus
        self.avail_nodes = self.n_nodes
        self.busy_gpu_seconds = 0.0
        self.avail_gpu_seconds = 0.0
        self.lost_gpu_seconds = 0.0
        self.evictions = 0
        self.records: List[IntervalRecord] = []

    def set_capacity(self, gpus: int, nodes: int) -> None:
        """Dynamic capacity under faults; applies to intervals closed
        after this call (the engine closes the pre-fault interval
        first, so each interval is priced at the capacity that was
        actually live during it)."""
        self.avail_gpus = max(0, int(gpus))
        self.avail_nodes = max(0, int(nodes))

    def add_loss(self, gpu_seconds: float, eviction: bool = False) -> None:
        """Charge fault waste: rolled-back progress or a fault-restart
        penalty, in GPU-seconds; ``eviction=True`` also counts one
        eviction."""
        self.lost_gpu_seconds += max(0.0, float(gpu_seconds))
        if eviction:
            self.evictions += 1

    def close_interval(self, t0: float, dt: float, busy_gpu_time: float,
                       busy_nodes: Set[int], running: int, waiting: int,
                       changed: int, sched_seconds: float) -> None:
        if dt <= 0.0:
            return
        denom = self.avail_gpus * dt
        rec = IntervalRecord(
            t=t0,
            gru=busy_gpu_time / denom if denom > 0.0 else 0.0,
            cru=(len(busy_nodes) / self.avail_nodes
                 if self.avail_nodes > 0 else 0.0),
            running=running,
            waiting=waiting,
            changed=changed,
            sched_seconds=sched_seconds,
            dt=dt)
        self.busy_gpu_seconds += busy_gpu_time
        self.avail_gpu_seconds += denom
        self.records.append(rec)

    def result(self, name: str, jobs: List[Job], total_seconds: float,
               n_events: int, sched_calls: int) -> EventSimResult:
        return EventSimResult(name, list(self.records), jobs, total_seconds,
                              gpu_seconds_busy=self.busy_gpu_seconds,
                              gpu_seconds_avail=self.avail_gpu_seconds,
                              gpu_seconds_lost=self.lost_gpu_seconds,
                              evictions=self.evictions,
                              n_events=n_events, sched_calls=sched_calls)


def result_fields(res) -> tuple:
    """Every field of a simulation result but the host time
    ``sched_seconds``: each job's arrival, finish, progress, restarts,
    evictions, lost work and last allocation, each round or interval
    record, and the totals.  Two runs that should agree (two solvers, or
    the port and the JAX package) agree when these are equal."""
    jobs = tuple((j.job_id, j.arrival, j.finish_time, j.done_iters,
                  j.restarts, j.evictions, j.lost_iters, j.attained_service,
                  sorted((j.alloc or {}).items())) for j in res.jobs)
    recs = tuple(dataclasses.astuple(dataclasses.replace(
        r, sched_seconds=0.0)) for r in res.rounds)
    tot = (res.scheduler, res.total_seconds, res.gpu_seconds_busy,
           res.gpu_seconds_avail, res.gpu_seconds_lost, res.evictions,
           getattr(res, "n_events", None), getattr(res, "sched_calls", None),
           res.avg_jct(), res.goodput(), res.gru_overall())
    return jobs, recs, tot

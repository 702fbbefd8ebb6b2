"""Simulation engines: round-quantized (paper §IV) and continuous-time.

The port's copy of ``repro.sim.engine``, without the observability and
sanitizer hooks (the kept branches are those the JAX package runs with
both off).  A consultation is timed with ``time.perf_counter()``.

``simulate_rounds``: every ``round_len`` seconds the scheduler is
consulted; steady rounds under a ``stable_when_idle`` scheduler
fast-forward to the next arrival, completion or fault boundary with
byte-identical metrics.

``simulate_events`` drops the round quantization: time advances from
event to event (arrival / predicted completion / fault / reschedule
quantum), progress accrues analytically over each inter-event interval,
and metrics are recorded per interval (``EventSimResult``).  While active
jobs are *waiting*, a ``round_len`` re-schedule quantum keeps retrying
them.  ``event_stream`` is the same engine as a co-routine that yields a
``ConsultPoint`` at every decision; ``simulate_events`` drives it with a
scheduler object.

Quantization differences between the two engines (the documented
tolerance for equivalence tests):

- the scheduler reacts to arrivals/completions *immediately* instead of
  at the next round boundary, so each completion can shift earlier by
  up to ``round_len``;
- GRU/CRU are time-weighted over intervals rather than averaged per
  round record;
- schedulers without ``stable_when_idle`` are re-consulted on a
  ``round_len`` quantum, so their decision *sequence* matches the round
  engine's up to the phase shift introduced by event-aligned calls.

Restart penalties are per-job when ``Job.restart_penalty`` is set; the
engine-level ``restart_penalty`` argument remains the default (10 s,
paper §IV).
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import time
from typing import Dict, List, Optional, Set

from repro_torch.core.types import Alloc, Cluster, Job, alloc_nodes, \
    alloc_size
from repro_torch.sim.events import FAULT_KINDS, EventKind, EventQueue
from repro_torch.sim.faults import KIND_SPOT, FaultState, \
    resolve_checkpoint_interval, resolve_faults, rollback_point, \
    select_evictions
from repro_torch.sim.metrics import EventSimResult, MetricsRecorder, \
    RoundRecord, SimResult

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


# ---------------------------------------------------------------------------
# round-quantized engine
# ---------------------------------------------------------------------------

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
                    solver: Optional[str] = None,
                    faults=None) -> SimResult:
    """Round-based simulation; O(events) on sparse traces via steady
    fast-forward.  ``solver`` ("cuda" | "numpy" | "auto") overrides the
    scheduler's pricing backend; decisions are backend-independent.

    ``faults`` (a ``FailureModel``, ``FailureTrace``, or iterable of
    windows) injects node failures/spot preemptions *quantized to round
    starts*: a window is active at the first round boundary >= its fail
    time.  Because the round engine commits progress whole rounds at a
    time, evictions at a boundary lose no iterations (the boundary is a
    de-facto checkpoint) — only the fault-restart penalty counts
    against goodput."""
    _apply_solver(scheduler, solver)
    jobs = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    _reset_jobs(jobs)
    total_gpus = cluster.total_gpus()
    n_nodes = len(cluster.nodes)
    ftrace = resolve_faults(faults, cluster)
    fs = FaultState(ftrace, cluster) if ftrace is not None else None
    fault_pending: Set[int] = set()
    busy_total = avail_total = lost_total = 0.0
    ev_total = 0
    arrivals = [j.arrival for j in jobs]          # sorted with jobs
    rounds: List[RoundRecord] = []
    t = 0.0
    rnd = 0
    while rnd < max_rounds:
        if all(j.is_done() for j in jobs):
            break
        avail_gpus, avail_nodes = total_gpus, n_nodes
        if fs is not None:
            if fs.advance_to(t):
                for j in select_evictions(jobs, fs.live_capacity()):
                    j.alloc = None
                    j.evictions += 1
                    ev_total += 1
                    fault_pending.add(j.job_id)
            avail_gpus, avail_nodes = fs.up_counts()
        view = fs.view() if fs is not None else cluster
        if view.nodes:
            t0 = time.perf_counter()
            desired = scheduler.schedule(t, round_len, jobs, view)
            sched_s = time.perf_counter() - t0
        else:
            desired = {}            # total outage: nothing schedulable
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
                if new is not None and j.job_id in fault_pending:
                    # fault-restart charge: this penalty replays work a
                    # fault destroyed, not a scheduler-chosen move
                    lost_total += penalty * alloc_size(new)
                    fault_pending.discard(j.job_id)
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
        if fs is not None:
            # never skip across a failure/recovery boundary: the skip
            # must stop at the first round start at/after the change
            nb = fs.next_change(t)
            if math.isfinite(nb):
                skip = min(skip, int(math.ceil((nb - t) / round_len)))
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
                     gpu_seconds_avail=avail_total,
                     gpu_seconds_lost=lost_total,
                     evictions=ev_total)


# ---------------------------------------------------------------------------
# continuous-time engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ConsultPoint:
    """One scheduling decision point of the continuous-time engine, as
    surfaced by :func:`event_stream`.

    The caller answers the yield with either a ``desired`` allocation
    map (``Dict[job_id, Alloc]``) or a ``(desired, sched_seconds)``
    tuple — the latter attributes real decision latency to the interval
    records, exactly like ``simulate_events`` does.

    ``completed`` lists the job ids whose completion events fired since
    the previous consult; callers wrapping a stateful scheduler must
    forward them via ``scheduler.note_completion()`` *before* asking
    for the next decision.

    The ``busy/avail/lost`` fields snapshot the run's cumulative
    GPU-second accounting at this decision point.
    """
    t: float
    round_len: float
    jobs: List[Job]                 # engine-owned sorted job list
    view: Cluster                   # live (fault-aware) cluster view
    completed: List[int]            # job ids finished since last consult
    queue_len: int                  # active jobs with no allocation
    down: frozenset = frozenset()   # node ids currently failed
    busy_gpu_seconds: float = 0.0
    avail_gpu_seconds: float = 0.0
    lost_gpu_seconds: float = 0.0
    evictions: int = 0


def _parse_action(sent) -> tuple:
    """Normalize a ``send()`` value into ``(desired, sched_seconds)``."""
    if sent is None:
        return {}, 0.0
    if isinstance(sent, tuple):
        desired, sched_s = sent
        return (desired or {}), float(sched_s)
    return sent, 0.0


def event_stream(jobs: List[Job], cluster: Cluster,
                 round_len: float = 360.0, max_events: int = 500000,
                 restart_penalty: float = RESTART_PENALTY,
                 faults=None,
                 checkpoint_interval: Optional[float] = None,
                 stable: bool = False,
                 name: str = "external"):
    """Step-driven co-routine mode of the continuous-time engine.

    A generator that runs the exact ``simulate_events`` transition
    kernel but *yields* a :class:`ConsultPoint` at every scheduling
    decision instead of calling a scheduler object; the caller
    ``send()``s the desired allocation map back (see
    :class:`ConsultPoint`).

    ``stable`` mirrors ``Scheduler.stable_when_idle``: when False the
    stream re-consults on a ``round_len`` quantum while any job is
    active; when True only while some active job is unallocated.
    ``name`` labels the returned :class:`EventSimResult`.

    Returns the result via ``StopIteration.value``.
    """
    jobs = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    _reset_jobs(jobs)
    by_id = {j.job_id: j for j in jobs}
    # permanent-infeasibility guard: a job demanding more devices than
    # the whole cluster has of its eligible types can never be placed by
    # any policy, so it must not keep the re-schedule quantum alive —
    # the run would spin to max_events.  Such jobs end with
    # finish_time=None (completed < n_jobs).
    cap_type: Dict[str, int] = {}
    for n in cluster.nodes:
        for r, c in n.gpus.items():
            cap_type[r] = cap_type.get(r, 0) + c
    never_fit = frozenset(
        j.job_id for j in jobs if j.n_workers > 0
        and sum(c for r, c in cap_type.items()
                if j.throughput.get(r, 0.0) > 0.0) < j.n_workers)
    q = EventQueue()
    for j in jobs:
        q.push_arrival(j.arrival, j.job_id)
    ftrace = resolve_faults(faults, cluster)
    fs = FaultState(ftrace, cluster) if ftrace is not None else None
    ckpt = resolve_checkpoint_interval(checkpoint_interval, faults)
    if fs is not None:
        for w in fs.trace:
            q.push_fault(w.fail_time,
                         EventKind.SPOT_PREEMPT if w.kind == KIND_SPOT
                         else EventKind.NODE_FAIL, w.node_id)
            if math.isfinite(w.recover_time):
                q.push_fault(w.recover_time, EventKind.NODE_RECOVER,
                             w.node_id)
    recorder = MetricsRecorder(cluster.total_gpus(), len(cluster.nodes))
    pen_until: Dict[int, float] = {j.job_id: 0.0 for j in jobs}
    # checkpoint anchoring for rollback: when the current allocation
    # started progressing (post-penalty) and from how many done iters
    prog_start: Dict[int, float] = {}
    prog_done0: Dict[int, float] = {}
    fault_pending: Set[int] = set()   # evicted, owing a fault-restart charge
    completed_since: List[int] = []   # finished since the last consult
    t = 0.0
    n_events = 0
    sched_calls = 0
    # changes/latency applied at the *start* of the open interval; attached
    # to the interval record when it closes at the next event
    open_changed = 0
    open_sched_s = 0.0

    def _accrue_and_record(t0: float, t1: float) -> None:
        dt = t1 - t0
        if dt <= 0.0:
            return
        busy_gpu_time = 0.0
        busy_nodes: Set[int] = set()
        running = 0
        for j in jobs:
            if not j.alloc or j.is_done():
                continue
            running += 1
            w = alloc_size(j.alloc)
            busy_gpu_time += w * dt
            busy_nodes.update(alloc_nodes(j.alloc))
            j.attained_service += w * dt
            eff = t1 - max(t0, pen_until[j.job_id])
            if eff > 0.0:
                rate = j.bottleneck_rate(j.alloc)
                # float-safety cap: stay strictly above the is_done()
                # threshold (1e-9) until the completion event fires
                j.done_iters = min(j.total_iters - 1e-8,
                                   j.done_iters + rate * w * eff)
        n_active = sum(1 for j in jobs
                       if not j.is_done() and j.arrival <= t0)
        recorder.close_interval(t0, dt, busy_gpu_time, busy_nodes,
                                running, n_active - running,
                                open_changed, open_sched_s)

    while q and n_events < max_events:
        batch = q.pop_batch()
        if not batch:
            break
        t_new = batch[0].time
        _accrue_and_record(t, t_new)
        t = t_new
        open_changed = 0
        open_sched_s = 0.0

        fault_hit = False
        cap_changed = False
        fault_only = all(ev.kind in FAULT_KINDS for ev in batch)
        for ev in batch:
            n_events += 1
            if ev.kind == EventKind.COMPLETION:
                j = by_id[ev.job_id]
                if j.is_done() and j.finish_time is not None:
                    continue
                # tie-order note: a completion predicted for exactly a
                # failure instant pops first (COMPLETION < NODE_FAIL),
                # so the job finishes and is never rolled back
                j.done_iters = j.total_iters
                j.finish_time = t
                j.alloc = None
                completed_since.append(j.job_id)
            elif ev.kind == EventKind.NODE_RECOVER:
                fs.recover(ev.node_id)
                cap_changed = True
            elif ev.kind in (EventKind.NODE_FAIL, EventKind.SPOT_PREEMPT):
                fs.fail(ev.node_id)
                fault_hit = True
                cap_changed = True

        if fault_hit:
            for j in select_evictions(jobs, fs.live_capacity()):
                w = alloc_size(j.alloc)
                rate_w = j.bottleneck_rate(j.alloc) * w
                run_s = t - prog_start.get(j.job_id, t)
                retained = rollback_point(
                    prog_done0.get(j.job_id, j.done_iters),
                    j.done_iters, rate_w, run_s, ckpt)
                lost = max(0.0, j.done_iters - retained)
                lost_gpu = (lost / rate_w) * w if rate_w > 0 else 0.0
                j.done_iters = retained
                j.lost_iters += lost
                j.evictions += 1
                j.alloc = None
                pen_until[j.job_id] = t
                fault_pending.add(j.job_id)
                recorder.add_loss(lost_gpu, eviction=True)
                q.invalidate_completion(j.job_id)
                open_changed += 1
        if cap_changed:
            g, nn = fs.up_counts()
            recorder.set_capacity(g, nn)
        if all(j.is_done() for j in jobs):
            break

        # a fault-only batch that evicted nobody and leaves no active
        # job unallocated cannot change any allocation — skip the
        # consult (and leave every completion prediction intact).
        if (fault_only and open_changed == 0
                and not any(not j.is_done() and j.arrival <= t
                            and j.alloc is None for j in jobs)):
            continue

        view = fs.view() if fs is not None else cluster
        if view.nodes:
            qlen = sum(1 for j in jobs if not j.is_done()
                       and j.arrival <= t and j.alloc is None)
            sent = yield ConsultPoint(
                t=t, round_len=round_len, jobs=jobs, view=view,
                completed=completed_since, queue_len=qlen,
                down=frozenset(fs.down) if fs is not None else frozenset(),
                busy_gpu_seconds=recorder.busy_gpu_seconds,
                avail_gpu_seconds=recorder.avail_gpu_seconds,
                lost_gpu_seconds=recorder.lost_gpu_seconds,
                evictions=recorder.evictions)
            desired, open_sched_s = _parse_action(sent)
            completed_since = []
            sched_calls += 1
        else:
            desired = {}            # total outage: wait for a recovery

        for j in jobs:
            if j.is_done():
                j.alloc = None
                continue
            if j.arrival > t:
                continue
            new = desired.get(j.job_id)
            if _alloc_equal(j.alloc, new):
                continue        # outstanding completion prediction stays valid
            if j.alloc is not None or new is not None:
                open_changed += 1
            if new is not None and j.alloc is not None:
                j.restarts += 1
            q.invalidate_completion(j.job_id)
            j.alloc = new
            if not new:
                pen_until[j.job_id] = t
                continue
            pen = _job_penalty(j, restart_penalty)
            pen_until[j.job_id] = t + pen
            rate = j.bottleneck_rate(new)
            w = alloc_size(new)
            if j.job_id in fault_pending:
                # fault-restart charge: this penalty replays work a
                # fault destroyed, not a scheduler-chosen move
                recorder.add_loss(pen * w)
                fault_pending.discard(j.job_id)
            prog_start[j.job_id] = t + pen
            prog_done0[j.job_id] = float(j.done_iters)
            if rate * w > 0:
                t_fin = t + pen + j.remaining_iters / (rate * w)
                q.push_completion(t_fin, j.job_id)

        # re-schedule quantum: always for rotating schedulers; for stable
        # ones only while some active job is still unallocated, so waiting
        # jobs are retried each round instead of silently starving.
        # During a total outage no quantum is pushed — the next
        # NODE_RECOVER triggers the consult — so the loop cannot spin on
        # an empty cluster.
        if ((fs is None or fs.any_up())
                and any(not j.is_done() and j.arrival <= t
                        and j.job_id not in never_fit
                        and (not stable or j.alloc is None) for j in jobs)):
            q.push_reschedule(t + round_len)

    total = max((j.finish_time or t) for j in jobs) if jobs else 0.0
    return recorder.result(name, jobs, total, n_events, sched_calls)


def simulate_events(scheduler, jobs: List[Job], cluster: Cluster,
                    round_len: float = 360.0, max_events: int = 500000,
                    restart_penalty: float = RESTART_PENALTY,
                    solver: Optional[str] = None,
                    faults=None,
                    checkpoint_interval: Optional[float] = None
                    ) -> EventSimResult:
    """Continuous-time simulation: t jumps to the next event.

    ``round_len`` keeps two roles: the scheduling quantum for schedulers
    without ``stable_when_idle`` (they are re-consulted every
    ``round_len`` while jobs are active), and the value passed to
    ``scheduler.schedule`` so scheduler-side heuristics see the same
    horizon as in round mode.  ``solver`` overrides the scheduler's
    pricing backend (see ``simulate_rounds``).

    ``faults`` (a ``FailureModel``, ``FailureTrace``, or iterable of
    windows) injects NODE_FAIL / SPOT_PREEMPT / NODE_RECOVER events at
    their exact times.  On a failure: every job holding devices on a
    down node — plus, under shrunken capacity, further victims in
    reverse payoff order — is evicted, its predicted completion
    invalidated, and its progress rolled back to the last checkpoint
    (``checkpoint_interval`` seconds of progress apart; defaults to the
    model's knob).  The rolled-back work and the extra restart penalty
    the job pays when it reallocates are charged as *lost* GPU-seconds.
    Scheduler consults price against the up-capacity view (one object
    per down-set, so a persistent PriceState is rebuilt only when the
    down-set changes).

    Built on :func:`event_stream`, so a policy stepping the stream
    directly makes decisions against byte-identical state.
    """
    _apply_solver(scheduler, solver)
    gen = event_stream(jobs, cluster, round_len=round_len,
                       max_events=max_events,
                       restart_penalty=restart_penalty, faults=faults,
                       checkpoint_interval=checkpoint_interval,
                       stable=getattr(scheduler, "stable_when_idle",
                                      False),
                       name=scheduler.name)
    send = None
    while True:
        try:
            cp = gen.send(send)
        except StopIteration as stop:
            return stop.value
        if cp.completed and hasattr(scheduler, "note_completion"):
            scheduler.note_completion()
        t0 = time.perf_counter()
        desired = scheduler.schedule(cp.t, cp.round_len, cp.jobs, cp.view)
        send = (desired, time.perf_counter() - t0)

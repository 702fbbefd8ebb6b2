"""Backends that plug schedulers and HadarE into the simulation engines.

The port's copy of ``repro.sim.adapters``, with its observability hooks
(``repro_torch.obs``: each HadarE consultation timed by ``obs.consult``,
faults, evictions, completions, intervals, fast-forwards and the
``hadare.consolidation`` instant after each sibling dedupe).
``simulate_hadare(sanitize=)`` checks the paper's invariants every round
(``repro_torch.analysis.invariants``).

``CountingScheduler`` wraps any ``repro_torch.core.schedulers.Scheduler``
with call/latency instrumentation, and ``run`` dispatches one workload to
either engine by name.

``simulate_hadare`` is the vectorized HadarE backend: progress
accounting, the Job Tracker's aggregation and the quota re-split are
NumPy array ops over (parent × copy) matrices — ``rw[p, c]`` holds copy
c of parent p's rate·workers, progress/aggregation/quota-splitting are
row reductions — while the scheduler consultation and sibling dedupe
keep the per-copy code path.  The matrices stay float64 NumPy on the
host: their order of addition is part of the result.  On steady rounds
(no allocation change, no completion, every live copy allocated under a
``stable_when_idle`` scheduler) it fast-forwards to the next
arrival/completion in bulk, replicating the per-round records.

``simulate_pods`` runs each pod of a ``multi_cluster`` topology as an
independent simulation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch import obs as _obs
from repro_torch.core.schedulers import Scheduler
from repro_torch.core.types import Cluster, Job, alloc_nodes, alloc_size
from repro_torch.analysis import invariants as _inv
from repro_torch.sim.engine import (RESTART_PENALTY, _alloc_equal,
                                    _apply_solver, _cap_by_key,
                                    _job_penalty, _reset_jobs,
                                    simulate_events, simulate_rounds)
from repro_torch.sim.faults import KIND_SPOT, FaultState, resolve_faults, \
    select_evictions
from repro_torch.sim.metrics import RoundRecord, SimResult


class CountingScheduler(Scheduler):
    """Instrumentation wrapper: counts schedule() consultations and their
    cumulative wall-clock, delegating everything else to the inner
    scheduler (including ``stable_when_idle`` / ``note_completion``)."""

    def __init__(self, inner: Scheduler):
        self.inner = inner
        self.name = inner.name
        self.preemptive = inner.preemptive
        self.stable_when_idle = inner.stable_when_idle
        self.calls = 0
        self.total_seconds = 0.0

    @property
    def solver(self):
        """Delegated so engine-level ``solver=`` overrides reach the
        wrapped scheduler (only exposed when the inner one has it)."""
        return getattr(self.inner, "solver", None)

    @solver.setter
    def solver(self, value):
        if hasattr(self.inner, "solver"):
            self.inner.solver = value

    def note_completion(self) -> None:
        if hasattr(self.inner, "note_completion"):
            self.inner.note_completion()

    def schedule(self, now, round_len, jobs, cluster):
        # plain StopWatch (not obs.consult): the engine already owns the
        # decision-latency histogram; a second timer here would double-count
        sw = _obs.StopWatch().start()
        out = self.inner.schedule(now, round_len, jobs, cluster)
        self.total_seconds += sw.stop()
        self.calls += 1
        return out


def run(scheduler: Scheduler, jobs: List[Job], cluster: Cluster,
        mode: str = "round", **kw) -> SimResult:
    """Dispatch one workload to an engine: ``round`` (quantized) or
    ``event`` (continuous-time)."""
    if mode == "round":
        return simulate_rounds(scheduler, jobs, cluster, **kw)
    if mode == "event":
        return simulate_events(scheduler, jobs, cluster, **kw)
    raise ValueError(f"unknown engine mode: {mode!r}")


# ---------------------------------------------------------------------------
# vectorized HadarE backend
# ---------------------------------------------------------------------------

def simulate_hadare(jobs: List[Job], cluster: Cluster,
                    round_len: float = 360.0, max_rounds: int = 20000,
                    restart_penalty: float = RESTART_PENALTY,
                    n_copies: Optional[int] = None,
                    scheduler=None, sync_overhead: float = 5.0,
                    fast_forward: bool = True,
                    solver: Optional[str] = None,
                    sanitize: bool = None,
                    faults=None) -> SimResult:
    """Vectorized, event-aware HadarE simulation (see module docstring).
    ``jobs`` are parents; metrics are reported at parent granularity.
    ``solver`` picks the Hadar core's pricing backend ("cuda" | "numpy" |
    "auto"); copies price through the same batched kernels (their
    ``single_node`` constraint is a kernel input).

    ``faults`` injects node failures round-quantized, like
    ``simulate_rounds``: copies on down nodes are evicted at the round
    boundary (progress is pooled per parent and committed per round, so
    nothing rolls back — the sibling copies' pool keeps everything the
    evicted copy contributed), and the extra restart penalty an evicted
    copy pays when it reallocates is charged against goodput.

    ``sanitize`` (default: the ``REPRO_SANITIZE`` flag) checks down
    allocations, capacity, sibling disjointness, progress, utilization
    and goodput every round."""
    from repro_torch.core.hadar import HadarScheduler
    from repro_torch.core.hadare import _dedupe_siblings, fork_job

    sched = scheduler or HadarScheduler()
    _apply_solver(sched, solver)
    _ob = _obs.get()
    _san = _inv.sanitize_enabled(sanitize)
    cap = _cap_by_key(cluster) if _san else None
    parents = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    _reset_jobs(parents)
    # HadarE copies are single-node (fork_job), so a parent whose gang
    # exceeds every node's eligible capacity can never place any copy.
    # Once every feasible parent is done and arrived, no further
    # progress is possible: stop instead of spinning to max_rounds.
    # Infeasible parents finish with finish_time=None, which honest
    # metrics (completed < n_jobs) surface downstream.
    def _best_node_cap(p: Job) -> int:
        return max((sum(c for r, c in n.gpus.items()
                        if p.throughput.get(r, 0.0) > 0.0)
                    for n in cluster.nodes), default=0)
    infeasible = np.array([_best_node_cap(p) < p.n_workers
                           for p in parents], dtype=bool)
    ftrace = resolve_faults(faults, cluster)
    fs = FaultState(ftrace, cluster) if ftrace is not None else None
    fault_pending: set = set()          # copy ids owing a restart charge
    busy_total = avail_total = lost_total = 0.0
    ev_total = 0
    P = len(parents)
    C = n_copies or len(cluster.nodes)
    n_nodes = len(cluster.nodes)
    total_gpus = cluster.total_gpus()

    total = np.array([p.total_iters for p in parents], dtype=float)
    done = np.zeros(P)
    registered = np.zeros(P, dtype=bool)
    arrivals = np.array([p.arrival for p in parents], dtype=float)
    copy_objs: List[List[Job]] = [[] for _ in range(P)]
    all_copies: List[Job] = []
    by_id: Dict[int, Job] = {}
    pos: Dict[int, tuple] = {}          # copy_id -> (parent_row, copy_col)
    # per-round (parent × copy) scratch matrices
    rw = np.zeros((P, C))               # rate * workers per allocated copy
    pen = np.zeros((P, C))              # checkpoint-restart penalty
    wmat = np.zeros((P, C))             # workers (devices held)
    allocated = np.zeros((P, C), dtype=bool)

    rounds: List[RoundRecord] = []
    t = 0.0
    rnd = 0
    while rnd < max_rounds:
        if bool(np.all(total - done <= 1e-9)):
            break
        if bool(np.all(infeasible | (total - done <= 1e-9))) \
                and bool(np.all(registered | infeasible)):
            break                       # only never-placeable work left
        for i, p in enumerate(parents):
            if not registered[i] and p.arrival <= t:
                cs = fork_job(p, C)
                copy_objs[i] = cs
                all_copies.extend(cs)
                for ci, c in enumerate(cs):
                    by_id[c.job_id] = c
                    pos[c.job_id] = (i, ci)
                registered[i] = True

        live = [c for c in all_copies if not c.is_done()]
        avail_gpus, avail_nodes = total_gpus, n_nodes
        if fs is not None:
            prev_down = set(fs.down)
            if fs.advance_to(t):
                if _ob.enabled:
                    for h in sorted(fs.down - prev_down):
                        win = fs.active_window(h, t)
                        _ob.fault("spot_preempt" if win is not None
                                  and win.kind == KIND_SPOT
                                  else "node_fail", t, h,
                                  win.recover_time if win else None)
                    for h in sorted(prev_down - fs.down):
                        _ob.fault("node_recover", t, h)
                victims = select_evictions(live, fs.live_capacity())
                for rank, c in enumerate(victims):
                    if _ob.enabled:
                        _ob.eviction(_obs.eviction_record(
                            t, c.job_id, c.n_workers, "capacity",
                            alloc_nodes(c.alloc), 0.0, 0.0,
                            c.bottleneck_rate(c.alloc)
                            * alloc_size(c.alloc), rank))
                    c.alloc = None
                    c.evictions += 1
                    pi, _ci = pos[c.job_id]
                    parents[pi].evictions += 1
                    fault_pending.add(c.job_id)
                    ev_total += 1
                if _san:
                    _inv.check_down_allocs(live, fs.down, t, "hadare")
            avail_gpus, avail_nodes = fs.up_counts()
        view = fs.view() if fs is not None else cluster
        qlen = (sum(1 for c in live if c.alloc is None)
                if _ob.enabled else 0)
        # the consult covers schedule + sibling dedupe
        if view.nodes:
            with _ob.consult("hadare", sched.name, t, qlen) as sw:
                desired = sched.schedule(t, round_len, live, view)
                n_raw = len(desired) if _ob.enabled else 0
                desired = _dedupe_siblings(desired, live, by_id)
            sched_s = sw.seconds
        else:
            desired = {}                # total outage
            n_raw = 0
            sched_s = 0.0
        if _ob.enabled:
            _ob.sim_instant("hadare.consolidation", t, raw=n_raw,
                            kept=len(desired), copies=len(live))

        changed = 0
        busy_nodes: set = set()
        rw[:] = 0.0
        pen[:] = 0.0
        wmat[:] = 0.0
        allocated[:] = False
        for c in live:
            pi, ci = pos[c.job_id]
            new = desired.get(c.job_id)
            if not _alloc_equal(c.alloc, new):
                changed += 1
                if new is not None and c.alloc is not None:
                    c.restarts += 1
                    parents[pi].restarts += 1
                pen[pi, ci] = _job_penalty(c, restart_penalty) if new else 0.0
                if new is not None and c.job_id in fault_pending:
                    # fault-restart charge: the penalty replays work a
                    # fault destroyed, not a scheduler-chosen move
                    lost_total += pen[pi, ci] * alloc_size(new)
                    fault_pending.discard(c.job_id)
            c.alloc = new
            if not new:
                continue
            allocated[pi, ci] = True
            rw[pi, ci] = c.bottleneck_rate(new) * alloc_size(new)
            wmat[pi, ci] = alloc_size(new)
            busy_nodes.update(alloc_nodes(new))
        if _san:
            _inv.check_cluster_allocs(live, cap, t, "hadare")
            for i in np.nonzero(registered)[0]:
                _inv.check_sibling_nodes(parents[i].job_id,
                                         copy_objs[i], t)

        # --- aggregation and re-split as (parent × copy) array ops -----
        eff = np.clip(round_len - pen - sync_overhead, 0.0, None)
        need = total - done                       # shared pool per parent
        iters = np.where(allocated,
                         np.minimum(rw * eff, need[:, None]), 0.0)
        got = iters.sum(axis=1)
        rate_sum = np.where(allocated, rw, 0.0).sum(axis=1)
        used = pen + np.where(rw > 0.0, iters / np.where(rw > 0.0, rw, 1.0),
                              0.0)
        busy_gpu_time = float(
            (wmat * np.minimum(used, round_len))[allocated].sum())

        was_live = (total - done) > 1e-9
        done = np.where(got > 0.0, np.minimum(total, done + got), done)
        finished = was_live & (got > 0.0) & ((total - done) <= 1e-9)
        for i in np.nonzero(got > 0.0)[0]:
            parents[i].done_iters = float(done[i])
            for c in copy_objs[i]:
                c.done_iters = float(done[i])
        for i in np.nonzero(finished)[0]:
            fin_used = (float(need[i] / rate_sum[i]) if rate_sum[i] > 0.0
                        else round_len)
            parents[i].finish_time = t + min(round_len, fin_used)
            if _ob.enabled:
                _ob.completion(parents[i].finish_time, parents[i].job_id,
                               parents[i].finish_time - parents[i].arrival)
            for c in copy_objs[i]:
                c.alloc = None
        if bool(finished.any()):
            sched.note_completion()
        # next-round step quotas, proportional to node throughput
        rem = total - done
        tot_rate = np.where(allocated, rw, 0.0).sum(axis=1)
        safe_tot = np.where(tot_rate > 0.0, tot_rate, 1.0)
        quota = np.where(tot_rate[:, None] > 0.0,
                         rem[:, None] * (rw / safe_tot[:, None]), 0.0)
        for i in np.nonzero(registered)[0]:
            for ci, c in enumerate(copy_objs[i]):
                c.quota = float(quota[i, ci])

        if _san:
            for i, p in enumerate(parents):
                if float(done[i]) < -1e-9 \
                        or float(done[i]) > float(total[i]) + 1e-6:
                    _inv.violate("progress-bound",
                                 "parent done_iters outside "
                                 "[0, total_iters]", engine="hadare",
                                 t=t, job=p.job_id, done=float(done[i]),
                                 total=float(total[i]))
        n_active = int((((total - done) > 1e-9) & (arrivals <= t)).sum())
        n_running = int(allocated.any(axis=1).sum())
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
        if _ob.enabled:
            r = rounds[-1]
            _ob.interval("hadare", r.t, round_len, r.gru, r.cru,
                         r.running, r.waiting, r.changed)
        if _san:
            _inv.check_utilization(rounds[-1].gru, rounds[-1].cru, t,
                                   "hadare")
        t += round_len
        rnd += 1

        # --- steady-round fast-forward --------------------------------
        # With no change/completion, every live copy allocated, and no
        # imminent arrival, a stable scheduler repeats the round verbatim
        # (kept allocations, empty waiting queue); replay it in bulk.
        if (not fast_forward
                or not getattr(sched, "stable_when_idle", False)
                or changed or bool(finished.any())):
            continue
        live_rows = (total - done) > 1e-9
        if not bool(live_rows.any()):
            continue
        # every copy of every live parent must hold an allocation: then
        # the waiting queue is empty and schedule() is a provable no-op
        if not bool(np.all(allocated[live_rows].all(axis=1))):
            continue
        got_rnd = got[live_rows]
        if not bool(np.all(got_rnd > 0.0)):
            continue
        k_comp = int(np.min(np.ceil(
            (total - done)[live_rows] / got_rnd)))
        unreg = np.nonzero(~registered)[0]
        k_arr = (int(np.ceil((arrivals[unreg[0]] - t) / round_len))
                 if unreg.size else k_comp)
        skip = min(k_comp - 1, k_arr, max_rounds - rnd)
        if fs is not None:
            # never skip across a failure/recovery boundary
            nb = fs.next_change(t)
            if np.isfinite(nb):
                skip = min(skip, int(np.ceil((nb - t) / round_len)))
        # strictness: bulk progress must leave every parent unfinished,
        # or the completion round (finish_time, note_completion) and the
        # per-copy capping it triggers would be skipped
        while skip > 0 and bool(np.any(
                done[live_rows] + got_rnd * skip
                >= total[live_rows] - 1e-9)):
            skip -= 1
        if skip <= 0:
            continue
        done = np.where(live_rows, done + got * skip, done)
        for i in np.nonzero(live_rows)[0]:
            parents[i].done_iters = float(done[i])
            for c in copy_objs[i]:
                c.done_iters = float(done[i])
        # re-split quotas from the post-skip remaining pool
        rem = total - done
        quota = np.where(tot_rate[:, None] > 0.0,
                         rem[:, None] * (rw / safe_tot[:, None]), 0.0)
        for i in np.nonzero(live_rows)[0]:
            for ci, c in enumerate(copy_objs[i]):
                c.quota = float(quota[i, ci])
        steady = rounds[-1]
        for i in range(skip):
            rounds.append(dataclasses.replace(
                steady, t=t + i * round_len, sched_seconds=0.0))
        busy_total += busy_gpu_time * skip
        avail_total += avail_gpus * round_len * skip
        if _ob.enabled:
            _ob.sim_span("fast_forward", t, t + skip * round_len,
                         rounds=skip, engine="hadare")
        t += skip * round_len
        rnd += skip

    total_s = max((p.finish_time or t) for p in parents) if parents else 0.0
    res = SimResult("hadare", rounds, parents, total_s,
                    gpu_seconds_busy=busy_total,
                    gpu_seconds_avail=avail_total,
                    gpu_seconds_lost=lost_total,
                    evictions=ev_total)
    if _san:
        _inv.check_goodput(res.goodput(), res.gru_overall(), "hadare")
    return res


# ---------------------------------------------------------------------------
# independent per-pod simulation (multi_cluster topologies)
# ---------------------------------------------------------------------------

def simulate_pods(scheduler_factory, jobs: List[Job], cluster: Cluster,
                  mode: str = "event", faults=None,
                  assign: Optional[Dict[int, int]] = None,
                  **kw) -> List[SimResult]:
    """Simulate each pod of a ``multi_cluster`` topology independently.

    Each pod gets its own scheduler instance (``scheduler_factory`` is
    called once per pod), its own sub-cluster, its own job partition
    (``assign`` maps job_id -> pod index; default round-robin in
    (arrival, job_id) order), and the failure schedule restricted to
    its own nodes.  Pods therefore fail and recover *independently*: a
    pod-local outage cannot perturb a sibling pod's decisions — the
    sibling's simulation is byte-for-byte the same with or without the
    outage.

    ``faults`` may be a ``FailureModel`` (sampled once against the full
    cluster; per-node RNG streams make the pod restriction bitwise
    equal to pod-local sampling), a ``FailureTrace``, or ``None``.
    Returns one ``SimResult`` per pod, in pod order."""
    if cluster.pods is None:
        raise ValueError("cluster has no pod topology metadata "
                         "(build it with trace.multi_cluster)")
    by_node = {n.node_id: n for n in cluster.nodes}
    n_pods = len(cluster.pods)
    order = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    if assign is None:
        assign = {j.job_id: i % n_pods for i, j in enumerate(order)}
    ftrace = resolve_faults(faults, cluster)
    results: List[SimResult] = []
    for pi, node_ids in enumerate(cluster.pods):
        sub = Cluster([by_node[h] for h in node_ids])
        pod_jobs = [j for j in order if assign.get(j.job_id) == pi]
        pod_faults = (ftrace.restrict(node_ids)
                      if ftrace is not None else None)
        if pod_faults is not None and not len(pod_faults):
            # an empty restriction runs the exact fault-free code path,
            # making "sibling pod unaffected" trivially bitwise
            pod_faults = None
        results.append(run(scheduler_factory(), pod_jobs, sub, mode=mode,
                           faults=pod_faults, **kw))
    return results

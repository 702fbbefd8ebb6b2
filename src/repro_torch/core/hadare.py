"""HadarE (paper §V): job forking + Job Tracker + consolidation rounds.

The port's copy of ``repro.core.hadare``.  Every job is forked into n
copies on an n-node cluster (Thm 3: n copies maximize CRU).  Copies are
registered with the Job Tracker under ``job_ID = max_job_count * i +
parent_id`` and scheduled by the unmodified Hadar core, constrained to
one node per copy and distinct nodes among siblings.  After each round
the tracker (1) aggregates completed steps across copies, (2)
consolidates model parameters by steps-weighted averaging (bookkeeping
only in the simulator), and (3) re-splits the remaining steps across
copies proportionally to node throughput.
"""
from __future__ import annotations

import copy as _copy
import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.hadar import HadarScheduler
from repro_torch.core.simulator import RESTART_PENALTY, SimResult
from repro_torch.core.types import Alloc, Cluster, Job, alloc_nodes, \
    alloc_size

MAX_JOB_COUNT = 10000  # paper's max_job_count in the job-ID formula


def fork_job(job: Job, n_copies: int) -> List[Job]:
    """Fork ``job`` into ``n_copies`` single-node copies (paper §V-A)."""
    copies = []
    for i in range(1, n_copies + 1):
        c = _copy.deepcopy(job)
        c.job_id = MAX_JOB_COUNT * i + job.job_id
        c.parent = job.job_id
        c.single_node = True
        c.alloc = None
        copies.append(c)
    return copies


@dataclasses.dataclass
class TrackedJob:
    parent: Job
    copies: List[Job]

    def live_copies(self) -> List[Job]:
        return [] if self.parent.is_done() else self.copies


class JobTracker:
    """Registers forked copies, aggregates steps, owns consolidation."""

    def __init__(self, n_nodes: int):
        self.n_nodes = n_nodes
        self.tracked: Dict[int, TrackedJob] = {}

    def register(self, job: Job, n_copies: Optional[int] = None) -> List[Job]:
        copies = fork_job(job, n_copies or self.n_nodes)
        self.tracked[job.job_id] = TrackedJob(job, copies)
        return copies

    def aggregate_round(self, round_progress: Dict[int, float],
                        now_start: float, round_len: float,
                        rates: Optional[Dict[int, float]] = None) -> List[int]:
        """round_progress: copy_id -> iterations completed this round.
        Sums per parent (result aggregation), marks completions, and
        mirrors the consolidated progress back onto every copy so each
        copy's 'remaining' matches the parent's.  Completion times are
        exact (copies finish ahead of the slot — paper §V-A 'early
        finish').  Returns finished parent ids."""
        finished = []
        for tj in self.tracked.values():
            p = tj.parent
            if p.is_done():
                continue
            need_before = p.remaining_iters
            got = sum(round_progress.get(c.job_id, 0.0) for c in tj.copies)
            if got <= 0:
                continue
            p.done_iters = min(p.total_iters, p.done_iters + got)
            for c in tj.copies:
                c.done_iters = p.done_iters
            if p.is_done():
                rate_sum = sum((rates or {}).get(c.job_id, 0.0)
                               for c in tj.copies)
                used = (need_before / rate_sum if rate_sum > 0
                        else round_len)
                p.finish_time = now_start + min(round_len, used)
                finished.append(p.job_id)
                for c in tj.copies:
                    c.alloc = None
        return finished

    def split_remaining(self) -> None:
        """Assign each copy its next-round step quota proportional to its
        current node's throughput (paper §V-B last paragraph).  Pure
        bookkeeping in simulation."""
        for tj in self.tracked.values():
            rem = tj.parent.remaining_iters
            rates = []
            for c in tj.copies:
                r = c.bottleneck_rate(c.alloc) if c.alloc else 0.0
                rates.append(r * (alloc_size(c.alloc) or 0))
            tot = sum(rates)
            for c, r in zip(tj.copies, rates):
                c.quota = rem * (r / tot) if tot > 0 else 0.0


def _dedupe_siblings(desired: Dict[int, Alloc], copies: List[Job],
                     by_id: Dict[int, Job]) -> Dict[int, Alloc]:
    """Among copies of one parent: at most one copy per node; drop the
    slower duplicate.  The sort is stable, so of two copies with the same
    rate the one first in ``desired`` keeps the node."""
    out: Dict[int, Alloc] = {}
    used_nodes: Dict[int, set] = {}
    order = sorted(desired.items(),
                   key=lambda kv: -(by_id[kv[0]].bottleneck_rate(kv[1])
                                    if kv[1] else 0.0))
    for cid, alloc in order:
        c = by_id[cid]
        if alloc is None:
            continue
        nodes = set(alloc_nodes(alloc))
        taken = used_nodes.setdefault(c.parent, set())
        if nodes & taken:
            continue
        taken |= nodes
        out[cid] = alloc
    return out


def simulate_hadare(jobs: List[Job], cluster: Cluster,
                    round_len: float = 360.0, max_rounds: int = 20000,
                    restart_penalty: float = RESTART_PENALTY,
                    n_copies: Optional[int] = None,
                    scheduler: Optional[HadarScheduler] = None,
                    sync_overhead: float = 5.0,
                    solver: Optional[str] = None) -> SimResult:
    """Round-based HadarE simulation.  ``jobs`` are parents; metrics are
    reported at parent granularity (SimResult.jobs == parents).

    ``sync_overhead`` charges every allocated copy per round for the
    tracker communication + model aggregation/consolidation (paper §VI-D:
    this is what makes excessively short slot times unfavorable).

    The implementation is the vectorized, event-aware backend in
    ``repro_torch.sim.adapters``: aggregation and quota re-splitting are
    (parent × copy) NumPy array ops, and steady rounds fast-forward to
    the next event."""
    from repro_torch.sim.adapters import simulate_hadare as _vectorized
    return _vectorized(jobs, cluster, round_len=round_len,
                       max_rounds=max_rounds,
                       restart_penalty=restart_penalty, n_copies=n_copies,
                       scheduler=scheduler, sync_overhead=sync_overhead,
                       solver=solver)

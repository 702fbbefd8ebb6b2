"""Hadar (Algorithm 1): round-based primal-dual scheduling with the
DP dual subroutine (Algorithm 2) for task-level heterogeneous allocation.

The port's copy of ``repro.core.hadar``, without the observability hooks
(the kept branches are those the JAX package runs with observability
off).  Running jobs keep their allocations and only the waiting queue is
allocated against the residual capacity; a full re-optimization (which
may preempt) happens when resources were freed by completions.
"""
from __future__ import annotations

import time
from typing import Dict, List

from repro_torch.core import batch_solver
from repro_torch.core.dp import Candidate, _find_alloc_arrays, \
    dp_allocation
from repro_torch.core.pricing import PriceState
from repro_torch.core.schedulers import Scheduler
from repro_torch.core.types import Alloc, Job
from repro_torch.core.utility import UtilityFn, effective_throughput
from repro_torch.device import DeviceLike


class HadarScheduler(Scheduler):
    name = "hadar"
    # incremental mode pins running jobs' allocations between completions,
    # so rounds with an empty waiting queue are provably no-ops
    stable_when_idle = True

    def __init__(self, horizon: float = 7 * 24 * 3600.0,
                 utility: UtilityFn = effective_throughput,
                 reallocate_on_free: bool = True,
                 max_exact_dp: int = 24,
                 work_conserving: bool = True,
                 solver: str = "auto", device: DeviceLike = None):
        """``solver``: "cuda" (kernels K4/K5 on the card), "numpy" (the
        per-job oracle) or "auto"; decisions are the same on each.
        ``device`` is where the kernels run: the card unless the caller
        asks for the CPU, where their plain versions run.  "cuda" raises
        ``RuntimeError`` where CUDA is absent and no CPU device is
        given."""
        batch_solver.resolve_backend(solver, 0, device)
        self.horizon = horizon
        self.utility = utility
        self.reallocate_on_free = reallocate_on_free
        self.max_exact_dp = max_exact_dp
        # After the primal-dual selection, backfill still-idle devices with
        # still-waiting jobs (mu gate skipped).
        self.work_conserving = work_conserving
        self.solver = solver
        self.device = device
        self._had_completion = True     # force full pass on round 0
        self.last_sched_seconds = 0.0   # scalability metric (Fig. 5)
        self.alpha = 0.0                # Thm 2 constant, for reporting
        # the last consultation's new allocations with their cost and
        # payoff: job_id -> Candidate (selection, then backfill)
        self.last_decisions: Dict[int, Candidate] = {}
        self._ps: PriceState = None     # persistent across consultations

    def note_completion(self) -> None:
        self._had_completion = True

    def schedule(self, now, round_len, jobs, cluster):
        t0 = time.perf_counter()
        active = [j for j in jobs if not j.is_done() and j.arrival <= now]
        out: Dict[int, Alloc] = {}

        full_pass = self.reallocate_on_free and self._had_completion
        self._had_completion = False

        running = [j for j in active if j.alloc]
        waiting = [j for j in active if not j.alloc]
        if full_pass:
            queue = sorted(active, key=lambda j: (j.arrival, j.job_id))
            kept: List[Job] = []
        else:
            queue = sorted(waiting, key=lambda j: (j.arrival, j.job_id))
            kept = running

        # persistent PriceState: the key arrays (and the cached device
        # tensors) are built once per cluster geometry; each consultation
        # re-primes bounds/gamma/free in place
        if self._ps is None or not self._ps.matches(cluster):
            self._ps = PriceState(cluster, active, self.horizon,
                                  self.utility, now, device=self.device)
        else:
            self._ps.refresh(active, now)
        ps = self._ps
        self.alpha = ps.alpha()
        for j in kept:                      # running jobs pin their gammas
            out[j.job_id] = j.alloc
        ps.commit_batch(j.alloc for j in kept)

        sel = dp_allocation(queue, None, ps, now, self.utility,
                            max_exact=self.max_exact_dp,
                            solver=self.solver)
        self.last_decisions = dict(sel)
        extra: Dict = {}
        for jid, cand in sel.items():
            out[jid] = cand.alloc
            for k, v in cand.alloc.items():
                extra[k] = extra.get(k, 0) + v
        ps.commit_batch(cand.alloc for cand in sel.values())

        if self.work_conserving:
            # backfill: waiting jobs onto idle devices, best payoff first.
            # The reference prices against (pre-selection free) - extra;
            # extra is exactly the allocations committed since the kept
            # jobs, so that difference *is* the live free_arr.
            for j in sorted(queue, key=lambda j: (j.arrival, j.job_id)):
                if j.job_id in out:
                    continue
                avail = ps.free_arr.copy()
                gamma = ps.gamma_arr.copy()
                for k, v in extra.items():      # seed double-count kept
                    m = ps.key_index.get(k)
                    if m is not None:
                        gamma[m] += v
                cand = _find_alloc_arrays(j, avail, gamma, ps, now,
                                          self.utility, force=True)
                if cand is None:
                    continue
                out[j.job_id] = cand.alloc
                self.last_decisions[j.job_id] = cand
                ps.commit(cand.alloc)
                for k, v in cand.alloc.items():
                    extra[k] = extra.get(k, 0) + v

        self.last_sched_seconds = time.perf_counter() - t0
        return out

"""Discrete-time trace-driven simulator (paper §IV): the public entry
point of the Hadar decision path.

``simulate(HadarScheduler(solver="cuda"), jobs, cluster)`` runs the
round engine of ``repro_torch.sim.engine`` with Hadar's dual subroutine
on the card (kernels K4 and K5); ``simulate_events`` is the
continuous-time engine.  Both take ``faults=``.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.schedulers import Scheduler
from repro_torch.core.types import Cluster, Job
from repro_torch.sim.engine import (RESTART_PENALTY,  # noqa: F401
                                    _alloc_equal, simulate_events,
                                    simulate_rounds)
from repro_torch.sim.metrics import (EventSimResult,  # noqa: F401
                                     RoundRecord, SimResult)


def simulate(scheduler: Scheduler, jobs: List[Job], cluster: Cluster,
             round_len: float = 360.0, max_rounds: int = 20000,
             restart_penalty: float = RESTART_PENALTY) -> SimResult:
    """Round-based simulation.  Every ``round_len`` seconds the scheduler
    is consulted; jobs whose allocation changed pay the checkpoint-restart
    penalty (per-job ``Job.restart_penalty`` when set, else
    ``restart_penalty``); progress accrues as x_j(t) * W *
    effective_seconds (Eq. 1a/1b).  Steady rounds under a
    ``stable_when_idle`` scheduler fast-forward to the next
    arrival/completion with byte-identical metrics."""
    return simulate_rounds(scheduler, jobs, cluster, round_len=round_len,
                           max_rounds=max_rounds,
                           restart_penalty=restart_penalty)

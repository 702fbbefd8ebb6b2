"""Job utility functions U_j(completion_time) — non-increasing (paper Eq. 1).

Default is the paper's *effective throughput*: E_j N_j / (f_j - a_j).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.types import Job

UtilityFn = Callable[[Job, float], float]


def effective_throughput(job: Job, completion_time: float) -> float:
    return job.total_iters / max(completion_time, 1e-9)


def weighted_inverse(weight: float = 1.0) -> UtilityFn:
    def u(job: Job, completion_time: float) -> float:
        return weight / max(completion_time, 1e-9)

    return u


def deadline_step(deadline: float, value: float = 1.0) -> UtilityFn:
    """Hydra-style: full value before the deadline, decays after."""
    def u(job: Job, completion_time: float) -> float:
        if completion_time <= deadline:
            return value
        return value * deadline / completion_time

    return u

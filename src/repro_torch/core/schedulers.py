"""Scheduler interface and the allocation helpers shared by schedulers.

The port's copy of the base class and helpers of
``repro.core.schedulers``; the Gavel, Tiresias and YARN-CS baselines are
not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.types import Alloc, Cluster, Job


class Scheduler:
    name = "base"
    preemptive = True
    # True => when every active job already holds an allocation and no
    # completion/arrival occurred, schedule() provably returns the same
    # allocations again; the simulator then fast-forwards to the next
    # event instead of re-consulting the scheduler every round.  Gavel and
    # Tiresias rotate allocations round-by-round, so they must stay False.
    stable_when_idle = False

    def schedule(self, now: float, round_len: float, jobs: List[Job],
                 cluster: Cluster) -> Dict[int, Alloc]:
        """Return the desired allocation for every job that should run in
        the next round (job_id -> Alloc).  Jobs absent from the map idle."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# helpers shared by the baselines
# ---------------------------------------------------------------------------

def _free_pool(cluster: Cluster, taken: Dict) -> Dict[Tuple[int, str], int]:
    free = {}
    for n in cluster.nodes:
        for r, c in n.gpus.items():
            free[(n.node_id, r)] = c - taken.get((n.node_id, r), 0)
    return free


def _take(taken: Dict, alloc: Alloc) -> None:
    for k, v in alloc.items():
        taken[k] = taken.get(k, 0) + v


def _single_type_alloc(cluster: Cluster, taken: Dict, gpu_type: str,
                       count: int) -> Optional[Alloc]:
    """Gang-allocate ``count`` GPUs of one type (consolidating on as few
    nodes as possible)."""
    free = _free_pool(cluster, taken)
    if sum(c for (h, r), c in free.items() if r == gpu_type) < count:
        return None
    nodes = sorted(cluster.nodes,
                   key=lambda n: -(free.get((n.node_id, gpu_type), 0)))
    alloc: Alloc = {}
    need = count
    for n in nodes:
        c = min(need, free.get((n.node_id, gpu_type), 0))
        if c > 0:
            alloc[(n.node_id, gpu_type)] = c
            need -= c
        if need == 0:
            return alloc
    return None


def _any_type_alloc(cluster: Cluster, taken: Dict,
                    count: int) -> Optional[Alloc]:
    """Gang-allocate ``count`` GPUs of any mix of types (YARN-CS style)."""
    free = _free_pool(cluster, taken)
    if sum(free.values()) < count:
        return None
    alloc: Alloc = {}
    need = count
    for (h, r), c in sorted(free.items(), key=lambda kv: -kv[1]):
        take = min(need, c)
        if take > 0:
            alloc[(h, r)] = take
            need -= take
        if need == 0:
            return alloc
    return None

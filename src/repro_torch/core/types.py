"""Entities of the scheduling problem (paper §III-A, Table I)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

Alloc = Dict[Tuple[int, str], int]   # (node_id, gpu_type) -> count


@dataclasses.dataclass
class Node:
    """Machine h with capacity c_h^r per device type r."""
    node_id: int
    gpus: Dict[str, int]
    pcie_scaling: float = 1.0        # Eq. 10 term (PCIe gen factor)

    def total(self) -> int:
        return sum(self.gpus.values())


@dataclasses.dataclass
class Cluster:
    nodes: List[Node]
    # pod topology metadata (multi_cluster): list of node-id groups.
    # Pods fail and can be simulated independently; None = single pod.
    pods: Optional[List[List[int]]] = None

    @property
    def gpu_types(self) -> List[str]:
        seen: Dict[str, None] = {}
        for n in self.nodes:
            for r in n.gpus:
                seen.setdefault(r)
        return list(seen)

    def capacity(self) -> Dict[str, int]:
        cap: Dict[str, int] = {}
        for n in self.nodes:
            for r, c in n.gpus.items():
                cap[r] = cap.get(r, 0) + c
        return cap

    def total_gpus(self) -> int:
        return sum(n.total() for n in self.nodes)

    def free_map(self, used: Alloc) -> Dict[Tuple[int, str], int]:
        free = {}
        for n in self.nodes:
            for r, c in n.gpus.items():
                free[(n.node_id, r)] = c - used.get((n.node_id, r), 0)
        return free


@dataclasses.dataclass
class Job:
    """DL training job j (W_j workers, E_j epochs, N_j iters/epoch,
    X_j^r iters/sec per device of type r)."""
    job_id: int
    arrival: float                   # seconds
    n_workers: int                   # W_j
    epochs: int                      # E_j
    iters_per_epoch: int             # N_j
    throughput: Dict[str, float]     # X_j^r
    model: str = "model"
    size: str = "M"
    parent: Optional[int] = None     # HadarE fork parent
    single_node: bool = False        # HadarE copies run on one node each
    # checkpoint-restart cost on allocation change, seconds.  None means
    # "use the engine default" (10 s, paper §IV); trace generators can
    # derive a per-job value from model size (big models checkpoint slower)
    restart_penalty: Optional[float] = None

    # --- mutable progress state (simulator-owned) ---
    done_iters: float = 0.0
    finish_time: Optional[float] = None
    attained_service: float = 0.0    # GPU-seconds (Tiresias LAS)
    alloc: Optional[Alloc] = None    # current allocation
    restarts: int = 0
    evictions: int = 0               # fault-driven involuntary restarts
    lost_iters: float = 0.0          # progress rolled back by evictions

    @property
    def total_iters(self) -> float:
        return float(self.epochs * self.iters_per_epoch)

    @property
    def remaining_iters(self) -> float:
        return max(0.0, self.total_iters - self.done_iters)

    def t_min(self) -> float:
        """Fastest possible runtime (Eq. below 7): N E / (W max_r X)."""
        return self.total_iters / (self.n_workers *
                                   max(self.throughput.values()))

    def t_max(self) -> float:
        xs = [x for x in self.throughput.values() if x > 0]
        return self.total_iters / (self.n_workers * min(xs))

    def bottleneck_rate(self, alloc: Alloc) -> float:
        """x_j(t) (Eq. 1b): iterations/sec at the slowest allocated type."""
        used = [self.throughput[r] for (_, r), c in alloc.items() if c > 0]
        return min(used) if used else 0.0

    def is_done(self) -> bool:
        return self.remaining_iters <= 1e-9


def clone_job(job: Job) -> Job:
    """Pristine copy of a job: static fields kept (own throughput dict),
    every simulator-owned mutable field reset.  Harnesses that run the
    same trace under several policies clone per run so one policy's
    ``SimResult.jobs`` can never be mutated by the next run."""
    return dataclasses.replace(
        job, throughput=dict(job.throughput), done_iters=0.0,
        finish_time=None, attained_service=0.0, alloc=None, restarts=0,
        evictions=0, lost_iters=0.0)


def clone_jobs(jobs: List[Job]) -> List[Job]:
    return [clone_job(j) for j in jobs]


def alloc_size(alloc: Optional[Alloc]) -> int:
    return sum(alloc.values()) if alloc else 0


def alloc_nodes(alloc: Optional[Alloc]) -> List[int]:
    return sorted({h for (h, _), c in (alloc or {}).items() if c > 0})

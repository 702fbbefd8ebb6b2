"""Workload synthesis: Philly-like trace (paper §IV-A, Table II) and the
physical-cluster workload mixes (paper §VI-B, Table III), plus the
Gavel-style throughput table X_j^r.

Throughput ratios follow the published heterogeneity observations [10]:
ResNet-50 sees ~10x V100-vs-K80, recurrent models far less — the spread
that makes task-level heterogeneity awareness matter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.types import Cluster, Job, Node
from repro_torch.sim.engine import RESTART_PENALTY

# iterations/sec per single device, by (model, gpu type) — relative
# magnitudes from Gavel's measurements [10]
THROUGHPUT_TABLE: Dict[str, Dict[str, float]] = {
    # model            V100    P100    T4     K80   TitanRTX  RTX3090 T400 A2000
    "resnet50":    {"v100": 3.00, "p100": 1.60, "t4": 1.30, "k80": 0.30,
                    "titanrtx": 3.20, "rtx3090": 3.60, "t400": 0.40,
                    "a2000": 1.10},
    "resnet18":    {"v100": 9.00, "p100": 5.40, "t4": 4.60, "k80": 1.50,
                    "titanrtx": 9.60, "rtx3090": 10.8, "t400": 1.70,
                    "a2000": 3.90},
    "lstm":        {"v100": 6.00, "p100": 4.20, "t4": 3.60, "k80": 2.00,
                    "titanrtx": 6.40, "rtx3090": 7.00, "t400": 2.10,
                    "a2000": 3.40},
    "cyclegan":    {"v100": 1.20, "p100": 0.65, "t4": 0.55, "k80": 0.12,
                    "titanrtx": 1.30, "rtx3090": 1.45, "t400": 0.15,
                    "a2000": 0.45},
    "transformer": {"v100": 4.00, "p100": 2.40, "t4": 2.00, "k80": 0.70,
                    "titanrtx": 4.30, "rtx3090": 4.80, "t400": 0.80,
                    "a2000": 1.90},
    "recorder":    {"v100": 2.20, "p100": 1.40, "t4": 1.20, "k80": 0.45,
                    "titanrtx": 2.40, "rtx3090": 2.70, "t400": 0.50,
                    "a2000": 1.10},
    "mima":        {"v100": 5.00, "p100": 3.20, "t4": 2.70, "k80": 1.10,
                    "titanrtx": 5.40, "rtx3090": 6.00, "t400": 1.20,
                    "a2000": 2.50},
    # A3C-like RL job: little accelerator-bound work -> small spread [10]
    "a3c":         {"v100": 2.00, "p100": 1.60, "t4": 1.50, "k80": 1.00,
                    "titanrtx": 2.10, "rtx3090": 2.20, "t400": 1.10,
                    "a2000": 1.50},
}

SIZE_GPU_HOURS = {"S": (0.1, 1.0), "M": (1.0, 10.0), "L": (10.0, 50.0),
                  "XL": (60.0, 100.0)}
MODEL_SIZE = {"resnet50": "XL", "resnet18": "S", "lstm": "L",
              "cyclegan": "M", "transformer": "L", "recorder": "XL",
              "mima": "M"}

# checkpoint-restart cost by model size: bigger models serialize more
# state, so preemption costs them more (the paper's flat 10 s — the
# engine default RESTART_PENALTY — is the M anchor; generators opt in
# via ``hetero_restarts=True``)
SIZE_RESTART_PENALTY = {"S": 4.0, "M": RESTART_PENALTY, "L": 22.0,
                        "XL": 45.0}


def restart_penalty_for(size: str) -> float:
    """Per-job checkpoint-restart penalty derived from model size."""
    return SIZE_RESTART_PENALTY.get(size, SIZE_RESTART_PENALTY["M"])


def restrict(model: str, types: List[str]) -> Dict[str, float]:
    return {r: THROUGHPUT_TABLE[model][r] for r in types}


def calibrate_iters(gpu_hours: float,
                    throughput: Dict[str, float]) -> tuple:
    """(epochs, iters_per_epoch) such that the job takes ``gpu_hours``
    on its median device type — shared by the synthetic generator and
    the CSV replay loader so both calibrate identically."""
    med = float(np.median(list(throughput.values())))
    total_iters = max(1.0, gpu_hours * 3600.0 * med)
    return max(1, int(total_iters // 100)), 100


# ---------------------------------------------------------------------------
# clusters
# ---------------------------------------------------------------------------

def simulation_cluster() -> Cluster:
    """Paper §IV: 15 nodes, 60 GPUs — 20 each of V100/P100/K80."""
    nodes = []
    nid = 0
    for r in ("v100", "p100", "k80"):
        for _ in range(5):                      # 5 nodes x 4 GPUs = 20
            nodes.append(Node(nid, {r: 4}))
            nid += 1
    return Cluster(nodes)


def grown_cluster(n_jobs: int) -> Cluster:
    """The scalability cluster of paper Fig. 5 (``benchmarks/
    fig5_scalability.py``): it grows with the workload, one node of four
    GPUs per eight jobs (at least 15), V100/P100/K80 in turn."""
    n_nodes = max(15, n_jobs // 8)
    types = ["v100", "p100", "k80"]
    return Cluster([Node(i, {types[i % 3]: 4}) for i in range(n_nodes)])


def motivation_cluster() -> Cluster:
    """Paper §II-A: 2x V100, 3x P100, 1x K80 (one GPU per node slot)."""
    nodes = [Node(0, {"v100": 2}), Node(1, {"p100": 3}), Node(2, {"k80": 1})]
    return Cluster(nodes)


def aws_cluster() -> Cluster:
    """Paper §VI-A: p3.2xlarge (V100) + 2x p2.xlarge (K80) + 2x g4dn (T4)."""
    return Cluster([
        Node(0, {"v100": 1}, pcie_scaling=1.0),
        Node(1, {"k80": 1}, pcie_scaling=0.8),
        Node(2, {"k80": 1}, pcie_scaling=0.8),
        Node(3, {"t4": 1}, pcie_scaling=1.0),
        Node(4, {"t4": 1}, pcie_scaling=1.0),
    ])


def testbed_cluster() -> Cluster:
    """Paper §VI-A lab testbed: TitanRTX, T4, T400, RTX3090, RTX A2000."""
    return Cluster([
        Node(0, {"titanrtx": 1}, pcie_scaling=0.8),   # PCIe 3.0
        Node(1, {"t4": 1}, pcie_scaling=0.8),
        Node(2, {"t400": 1}, pcie_scaling=0.8),
        Node(3, {"rtx3090": 1}, pcie_scaling=1.0),    # PCIe 4.0
        Node(4, {"a2000": 1}, pcie_scaling=1.0),
    ])


def multi_cluster(n_pods: int = 3, nodes_per_pod: int = 5,
                  gpus_per_node: int = 4,
                  pod_types: Optional[List[str]] = None,
                  mixed_frac: float = 0.0, seed: int = 0) -> Cluster:
    """Fleet of heterogeneous sub-clusters: each pod is a homogeneous
    node group of one GPU generation (new DGX pods next to legacy racks).
    ``mixed_frac`` > 0 converts that fraction of nodes per pod into
    mixed-type boxes (half this pod's type, half the next pod's) — the
    awkward topologies task-level heterogeneity awareness exploits."""
    pod_types = pod_types or ["v100", "p100", "k80", "t4", "rtx3090"]
    rng = np.random.RandomState(seed)
    nodes: List[Node] = []
    pods: List[List[int]] = []
    nid = 0
    for p in range(n_pods):
        r = pod_types[p % len(pod_types)]
        r_next = pod_types[(p + 1) % len(pod_types)]
        n_mixed = int(round(nodes_per_pod * mixed_frac))
        pod_ids: List[int] = []
        for i in range(nodes_per_pod):
            if i < n_mixed and r != r_next:
                half = max(1, gpus_per_node // 2)
                gpus = {r: half, r_next: gpus_per_node - half}
            else:
                gpus = {r: gpus_per_node}
            nodes.append(Node(nid, gpus,
                              pcie_scaling=float(rng.choice([0.8, 1.0]))))
            pod_ids.append(nid)
            nid += 1
        pods.append(pod_ids)
    # pods metadata: each pod can be simulated independently (pod-local
    # faults stay pod-local)
    return Cluster(nodes, pods=pods)


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

def motivation_jobs() -> List[Job]:
    """Paper §II-A: J1 (3 GPUs, 80 epochs), J2 (2, 30), J3 (2, 50)."""
    types = ["v100", "p100", "k80"]
    mk = lambda jid, w, e, tp: Job(jid, 0.0, w, e, 10, tp)
    return [
        mk(1, 3, 80, {"v100": 1.00, "p100": 0.60, "k80": 0.10}),
        mk(2, 2, 30, {"v100": 0.50, "p100": 0.40, "k80": 0.10}),
        mk(3, 2, 50, {"v100": 0.80, "p100": 0.50, "k80": 0.10}),
    ]


def philly_trace(n_jobs: int = 480, seed: int = 0,
                 types: Optional[List[str]] = None,
                 all_at_start: bool = True,
                 arrival_pattern: Optional[str] = None,
                 hetero_restarts: bool = False) -> List[Job]:
    """Synthetic Microsoft-trace-like workload (§IV-A): size classes
    sampled uniformly, GPU demand heavy-tailed in {1,2,4,8}, models per
    Table II, runtimes drawn from the class's GPU-hour range.

    ``arrival_pattern`` overlays a non-trivial arrival process (see
    ``bursty_arrivals`` / ``diurnal_arrivals``) on the jobs; the default
    ``None`` keeps the original all-at-start / uniform behaviour (and the
    exact RNG stream) for reproducibility.  ``hetero_restarts`` assigns
    each job a size-derived checkpoint-restart penalty
    (``restart_penalty_for``); off by default so existing fixed-seed
    results are untouched."""
    rng = np.random.RandomState(seed)
    types = types or ["v100", "p100", "k80"]
    models = ["resnet50", "resnet18", "lstm", "cyclegan", "transformer"]
    jobs: List[Job] = []
    for i in range(n_jobs):
        model = models[rng.randint(len(models))]
        size = MODEL_SIZE[model]
        lo, hi = SIZE_GPU_HOURS[size]
        gpu_hours = rng.uniform(lo, hi)
        # demand correlates with size (Philly: big jobs request many GPUs)
        w_choices = {"S": [1, 1, 2], "M": [1, 2, 2, 4], "L": [2, 4, 4, 8],
                     "XL": [4, 8, 8]}[size]
        w = int(rng.choice(w_choices))
        tp = restrict(model, types)
        # calibrate E*N so the job takes ``gpu_hours`` on the median type
        epochs, ipe = calibrate_iters(gpu_hours, tp)
        arrival = 0.0 if all_at_start else float(rng.uniform(0, 3600 * 8))
        jobs.append(Job(i, arrival, w,
                        epochs=epochs,
                        iters_per_epoch=ipe,
                        throughput=tp, model=model, size=size,
                        restart_penalty=(restart_penalty_for(size)
                                         if hetero_restarts else None)))
    if arrival_pattern is not None:
        gens = {"bursty": bursty_arrivals, "diurnal": diurnal_arrivals}
        arrivals = gens[arrival_pattern](n_jobs, seed=seed + 1)
        for j, a in zip(jobs, arrivals):
            j.arrival = float(a)
    return jobs


# ---------------------------------------------------------------------------
# arrival processes (Philly/Helios characterization: bursty, long-tailed,
# strongly diurnal — Hu et al. 2021)
# ---------------------------------------------------------------------------

def bursty_arrivals(n: int, seed: int = 0, n_bursts: int = 8,
                    span: float = 8 * 3600.0,
                    burst_sigma: float = 180.0) -> np.ndarray:
    """Submission storms: jobs clump around a few burst centers whose
    sizes are heavy-tailed (a user re-submitting a sweep, a pipeline
    firing) — the regime where incremental scheduling pays off."""
    rng = np.random.RandomState(seed)
    centers = np.sort(rng.uniform(0.0, span, n_bursts))
    weights = rng.pareto(1.5, n_bursts) + 1.0     # long-tailed burst sizes
    which = rng.choice(n_bursts, size=n, p=weights / weights.sum())
    t = centers[which] + rng.normal(0.0, burst_sigma, n)
    return np.sort(np.clip(t, 0.0, span))


def diurnal_arrivals(n: int, seed: int = 0, days: int = 2,
                     period: float = 86400.0, peak_hour: float = 14.0,
                     trough_frac: float = 0.15) -> np.ndarray:
    """Inhomogeneous Poisson by thinning: a sinusoidal day/night cycle
    peaking at ``peak_hour`` with the night rate at ``trough_frac`` of
    the peak — the Helios/Philly diurnal load shape."""
    rng = np.random.RandomState(seed)
    span = days * period
    out: List[float] = []
    while len(out) < n:
        t = rng.uniform(0.0, span, max(n, 64))
        phase = 2.0 * np.pi * (t / period - peak_hour / 24.0)
        rate = trough_frac + (1.0 - trough_frac) * 0.5 * (1 + np.cos(phase))
        out.extend(t[rng.uniform(0.0, 1.0, t.size) < rate].tolist())
    return np.sort(np.array(out[:n]))


# workload mixes of §VI-B (M-1 .. M-12)
MIXES = {
    "M-1": ["mima"],
    "M-3": ["transformer", "mima", "mima"],
    "M-4": ["resnet18", "lstm", "transformer", "mima"],
    "M-5": ["resnet18", "lstm", "transformer", "recorder", "mima"],
    "M-8": ["resnet18", "lstm", "transformer", "recorder"] + ["mima"] * 4,
    "M-10": ["resnet18", "lstm", "transformer", "recorder"] + ["mima"] * 6,
    "M-12": ["resnet18", "lstm", "transformer", "recorder"] + ["mima"] * 8,
}


def mix_jobs(mix: str, cluster: Cluster, seed: int = 0,
             base_epochs: int = 30,
             hetero_restarts: bool = False) -> List[Job]:
    """Physical-cluster workload mixes: single-GPU jobs (the paper's
    clusters use one GPU per node) with per-model epoch counts scaled so
    mixes finish in a few thousand seconds."""
    rng = np.random.RandomState(seed)
    types = cluster.gpu_types
    jobs = []
    epochs_by_size = {"S": 20, "M": 30, "L": 40, "XL": 50}
    for i, model in enumerate(MIXES[mix]):
        tp = restrict(model, types)
        size = MODEL_SIZE[model]
        jobs.append(Job(i, 0.0, 1, epochs_by_size[size],
                        iters_per_epoch=60, throughput=tp, model=model,
                        size=size,
                        restart_penalty=(restart_penalty_for(size)
                                         if hetero_restarts else None)))
    return jobs

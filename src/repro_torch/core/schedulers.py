"""Scheduler interface + the three baselines from the paper's evaluation:
Gavel (job-level heterogeneity-aware), Tiresias (heterogeneity-unaware
2-queue LAS), YARN-CS (FIFO capacity scheduler, non-preemptive).

The port's copy of ``repro.core.schedulers``: host NumPy, as there.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

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


# ---------------------------------------------------------------------------
# Gavel [10] — job-level heterogeneity-aware, optimization + priority rounds
# ---------------------------------------------------------------------------

class GavelScheduler(Scheduler):
    """Allocation matrix Y via max-min water-filling over normalized
    throughputs, then round-based realization with priority
    Y[j,r] / rounds_received[j,r] (paper §II, [10])."""

    name = "gavel"

    def __init__(self):
        self.rounds_received: Dict[Tuple[int, str], int] = {}

    @staticmethod
    def allocation_matrix(jobs: List[Job], cluster: Cluster,
                          iters: int = 40, step: float = 0.05) -> np.ndarray:
        types = cluster.gpu_types
        cap = cluster.capacity()
        J = len(jobs)
        R = len(types)
        Y = np.zeros((J, R))
        cap_left = np.array([float(cap[r]) for r in types])
        frac_left = np.ones(J)
        norm = np.array([[j.throughput.get(r, 0.0) for r in types]
                         for j in jobs])
        norm = norm / np.maximum(norm.max(axis=1, keepdims=True), 1e-9)
        w_arr = np.array([float(j.n_workers) for j in jobs])
        ji_all = np.arange(J)
        for _ in range(iters):
            # While capacity is plentiful the sweep order cannot change any
            # job's choice, so the whole sweep collapses to one vector
            # step; near exhaustion (a type may cross some job's
            # step*W eligibility threshold mid-sweep) fall back to the
            # order-sensitive scalar sweep.
            active = frac_left > 1e-9
            eligible = (norm > 0) & (cap_left[None, :] >= step
                                     * w_arr[:, None])
            masked = np.where(eligible, norm, -1.0)
            best_r = np.argmax(masked, axis=1)
            doers = active & (masked[ji_all, best_r] > 0)
            if not doers.any():
                break
            d = np.minimum(step, frac_left)
            taken = np.bincount(best_r[doers], weights=(d * w_arr)[doers],
                                minlength=R)
            # largest gang among jobs eligible for each type at sweep start:
            # if end-of-sweep capacity stays above every such threshold, no
            # eligibility bit can have flipped mid-sweep.  The 1e-9 slack
            # routes knife-edge sweeps (caps landing exactly on a step*W
            # boundary) to the scalar path — real slack is ≥ one step.
            w_elig = np.where(eligible, w_arr[:, None], 0.0).max(axis=0)
            # least-served job first -> approximate max-min fairness;
            # ties (equal frac_left) must break by job index, so the
            # sweep order — and with it capacity drain under scarcity —
            # replays identically across NumPy builds
            order = np.argsort(1.0 - frac_left, kind="stable")
            if (cap_left - taken >= step * w_elig + 1e-9).all():
                np.add.at(Y, (ji_all[doers], best_r[doers]), d[doers])
                frac_left[doers] -= d[doers]
                # capacity must drain in sweep order with sequential
                # subtraction — a vectorized sum drifts in the last bits
                # and caps sit exactly on eligibility thresholds
                xs = d * w_arr
                for ji in order:
                    if doers[ji]:
                        cap_left[best_r[ji]] -= xs[ji]
                continue
            progress = False
            for ji in order:
                if frac_left[ji] <= 1e-9:
                    continue
                w = jobs[ji].n_workers
                best, best_ri = -1.0, -1
                for ri in range(R):
                    if cap_left[ri] >= step * w and norm[ji, ri] > best \
                            and norm[ji, ri] > 0:
                        best, best_ri = norm[ji, ri], ri
                if best_ri < 0:
                    continue
                dd = min(step, frac_left[ji], cap_left[best_ri] / w)
                Y[ji, best_ri] += dd
                frac_left[ji] -= dd
                cap_left[best_ri] -= dd * w
                progress = True
            if not progress:
                break
        return Y

    def schedule(self, now, round_len, jobs, cluster):
        """Priority round-robin realization of Y, batched: priorities
        Y[j,r] / (1 + rounds_received) are ranked in one stable argsort
        (ties fall back to the seed's (job, type) insertion order), and
        each gang allocation is one cumulative-sum pass over a live
        free[node, type] matrix instead of a per-job ``_single_type_alloc``
        free-pool rebuild.  Decisions are identical to the scalar loop
        (tests/test_engine_equivalence.py pins this against the vendored
        reference)."""
        active = [j for j in jobs if not j.is_done() and j.arrival <= now]
        if not active:
            return {}
        types = cluster.gpu_types
        Y = self.allocation_matrix(active, cluster)
        J, R = Y.shape
        tcol = {r: ri for ri, r in enumerate(types)}
        jrow = {j.job_id: ji for ji, j in enumerate(active)}
        tp = np.array([[j.throughput.get(r, 0.0) for r in types]
                       for j in active])
        recv = np.zeros((J, R))
        for (jid, r), n in self.rounds_received.items():
            ji = jrow.get(jid)
            ri = tcol.get(r)
            if ji is not None and ri is not None:
                recv[ji, ri] = n
        vals = np.where((Y > 0) & (tp > 0), Y / (1.0 + recv), -np.inf)
        order = np.argsort(-vals, axis=None, kind="stable")

        # live free matrix, nodes in cluster order (seed tie-breaking)
        free = np.array([[n.gpus.get(r, 0) for r in types]
                         for n in cluster.nodes], dtype=np.int64)
        node_ids = [n.node_id for n in cluster.nodes]
        out: Dict[int, Alloc] = {}
        for fi in order:
            ji, ri = divmod(int(fi), R)
            if vals[ji, ri] == -np.inf:
                break
            j = active[ji]
            if j.job_id in out:
                continue
            w = j.n_workers
            if w <= 0:          # seed's gang allocator never places these
                continue
            col = free[:, ri]
            if int(col.sum()) < w:
                continue
            # gang-allocate consolidating on as few nodes as possible:
            # most-free nodes first, greedy cumulative take
            nd = np.argsort(-col, kind="stable")
            csum = np.cumsum(col[nd])
            k = int(np.searchsorted(csum, w))
            take = col[nd[:k + 1]].copy()
            take[k] -= int(csum[k]) - w
            free[nd[:k + 1], ri] -= take
            r = types[ri]
            out[j.job_id] = {(node_ids[int(nd[i])], r): int(take[i])
                             for i in range(k + 1) if take[i] > 0}
            self.rounds_received[(j.job_id, r)] = \
                self.rounds_received.get((j.job_id, r), 0) + 1
        return out


# ---------------------------------------------------------------------------
# Tiresias [4] — heterogeneity-unaware, two-queue LAS (Promote disabled)
# ---------------------------------------------------------------------------

class TiresiasScheduler(Scheduler):
    name = "tiresias"

    def __init__(self, queue_threshold: float = 3600.0):
        self.threshold = queue_threshold  # attained GPU-seconds boundary

    def schedule(self, now, round_len, jobs, cluster):
        active = [j for j in jobs if not j.is_done() and j.arrival <= now]
        # queue 1 (low attained service) scheduled before queue 2; within a
        # queue: least-attained-service first, FIFO tiebreak
        q1 = [j for j in active if j.attained_service < self.threshold]
        q2 = [j for j in active if j.attained_service >= self.threshold]
        q1.sort(key=lambda j: (j.attained_service, j.arrival))
        q2.sort(key=lambda j: (j.attained_service, j.arrival))
        taken: Dict = {}
        out: Dict[int, Alloc] = {}
        for j in q1 + q2:
            # heterogeneity-unaware: single type, whichever has most free
            free = _free_pool(cluster, taken)
            by_type: Dict[str, int] = {}
            for (h, r), c in free.items():
                by_type[r] = by_type.get(r, 0) + c
            for r in sorted(by_type, key=lambda r: -by_type[r]):
                if j.throughput.get(r, 0) <= 0:
                    continue
                alloc = _single_type_alloc(cluster, taken, r, j.n_workers)
                if alloc:
                    out[j.job_id] = alloc
                    _take(taken, alloc)
                    break
        return out


# ---------------------------------------------------------------------------
# YARN-CS [6] — FIFO, non-preemptive, type-blind
# ---------------------------------------------------------------------------

class YarnCSScheduler(Scheduler):
    name = "yarn-cs"
    preemptive = False
    stable_when_idle = True   # non-preemptive: running jobs keep allocs

    def schedule(self, now, round_len, jobs, cluster):
        taken: Dict = {}
        out: Dict[int, Alloc] = {}
        # running jobs keep their allocation (non-preemptive)
        for j in jobs:
            if j.alloc and not j.is_done():
                out[j.job_id] = j.alloc
                _take(taken, j.alloc)
        for j in sorted(jobs, key=lambda j: (j.arrival, j.job_id)):
            if j.is_done() or j.job_id in out or j.arrival > now:
                continue
            # same-type first (node-label queues), mixed as a last resort
            alloc = None
            free = _free_pool(cluster, taken)
            by_type: Dict[str, int] = {}
            for (h, r), c in free.items():
                by_type[r] = by_type.get(r, 0) + c
            for r in sorted(by_type, key=lambda r: -by_type[r]):
                alloc = _single_type_alloc(cluster, taken, r, j.n_workers)
                if alloc:
                    break
            if alloc is None:
                alloc = _any_type_alloc(cluster, taken, j.n_workers)
            if alloc:
                out[j.job_id] = alloc
                _take(taken, alloc)
        return out

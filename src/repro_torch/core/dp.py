"""Algorithm 2: DP_allocation + FIND_ALLOC — the dual subroutine.

The port's copy of ``repro.core.dp``, without the observability and
sanitizer hooks.  FIND_ALLOC builds candidate task-level allocations for
one job:
  * consolidated — pack all W_j tasks on the fewest servers, preferring
    GPU types with the highest X_j^r;
  * non-consolidated — spread tasks across servers picking globally
    cheapest/fastest devices; a communication cost is added per extra
    server (paper lines 26-27).
The candidate with maximum payoff wins; it is accepted iff the payoff
mu_j = U_j(f_hat - a_j) - cost is positive (lines 28-32).

DP_allocation walks the queue with a select/skip branch per job,
memoizing on (index, server-state), and returns the subset of jobs +
allocations maximizing total payoff; long queues take a greedy pass.

``solver`` selects the backend for the queue-wide scans: ``"cuda"``
prices every queued job in one launch of kernel K4
(``batch_solver.find_alloc_batch``) and runs the greedy commit through
conflict-free waves and kernel K5 (``batch_solver.commit_greedy``);
``"numpy"`` keeps the per-job path below, which is the bitwise oracle of
both; ``"auto"``/None takes the card when there is one and the queue
clears the crossover.  Decisions are the same on every backend.

``free=None`` prices against the PriceState's persistent ``free_arr``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.pricing import PriceState
from repro_torch.core.types import Alloc, Job
from repro_torch.core.utility import UtilityFn

# price paid per extra server spanned by a spread allocation, as a fraction
# of the job's per-unit utility — models the parameter-sync bandwidth cost
COMM_COST_FRAC = 0.05


@dataclasses.dataclass
class Candidate:
    alloc: Alloc
    cost: float
    payoff: float
    rate: float      # bottleneck iterations/sec (x_j)


def find_alloc(job: Job, free: Optional[Dict[Tuple[int, str], int]],
               ps: PriceState, now: float, utility: UtilityFn,
               extra_gamma: Optional[Dict] = None,
               force: bool = False) -> Optional[Candidate]:
    """Best feasible task-level allocation for ``job`` at current prices.

    ``free`` is a free-count dict, or None to price against the
    PriceState's persistent ``free_arr``.  ``extra_gamma`` holds device
    counts already claimed by jobs selected earlier in the current DP
    branch.  ``force`` skips the mu_j > 0 admission gate (backfill).
    """
    extra = extra_gamma or {}
    avail = ps.free_arr.copy() if free is None else ps.free_to_arr(free)
    gamma = ps.gamma_arr.copy()
    for k, v in extra.items():
        m = ps.key_index.get(k)
        if m is not None:
            avail[m] -= v
            gamma[m] += v
    return _find_alloc_arrays(job, avail, gamma, ps, now, utility, force)


def _find_alloc_arrays(job: Job, avail: np.ndarray, gamma: np.ndarray,
                       ps: PriceState, now: float, utility: UtilityFn,
                       force: bool) -> Optional[Candidate]:
    """Array-state core of FIND_ALLOC.  ``avail`` = free - extra and
    ``gamma`` = committed + extra, both on PriceState's key axis."""
    W = job.n_workers
    # GPU types sorted by job throughput, descending (line 23)
    types = sorted([r for r in ps.cluster.gpu_types
                    if job.throughput.get(r, 0) > 0],
                   key=lambda r: -job.throughput[r])
    if not types:
        return None
    K = len(types)
    x_types = np.array([job.throughput[r] for r in types])

    # rank of each key's type in the preference order; K = unusable
    rank_of_col = np.full(len(ps.cluster.gpu_types), K, dtype=np.intp)
    for j, r in enumerate(types):
        rank_of_col[ps.cluster.gpu_types.index(r)] = j
    rank = rank_of_col[ps.type_col]
    usable = rank < K

    # payoff depends on the allocation only through its bottleneck rate,
    # so the job's utility is evaluated once per type (Eq. 1b)
    rem = job.remaining_iters
    u_table = np.array([
        utility(job, max(now + rem / (x * max(1, W)) - job.arrival, 1e-9))
        for x in x_types])

    # marginal unit prices for every key, out to the deepest pool depth
    c_sp = int(max(avail.max(initial=0.0), 0.0))
    P = ps.unit_prices(gamma, c_sp) if c_sp else \
        np.zeros((len(ps.keys), 0))

    # ---- consolidated: all tasks on one server (line 24) ---------------
    N = ps.n_node_rows
    A = np.zeros((N, K))
    A[ps.node_row[usable], rank[usable]] = avail[usable]
    Apos = np.maximum(A, 0.0)
    rawcum = np.cumsum(A, axis=1)     # the reference's total_free per prefix
    poscum = np.cumsum(Apos, axis=1)
    feas_any = rawcum >= W
    feasible = feas_any.any(axis=1)
    k_first = np.argmax(feas_any, axis=1)        # first feasible prefix - 1
    take = np.clip(W - (poscum - Apos), 0.0, Apos)
    j_last = np.argmax(poscum >= W, axis=1)      # slowest type actually used

    c_pack = int(min(max(Apos.max(initial=0.0), 0.0), W))
    cumP = np.zeros((len(ps.keys), c_pack + 1))
    np.cumsum(P[:, :c_pack], axis=1, out=cumP[:, 1:])
    cumP_nk = np.zeros((N, K, c_pack + 1))
    cumP_nk[ps.node_row[usable], rank[usable], :] = cumP[usable]
    packed_cost = np.take_along_axis(
        cumP_nk, take.astype(np.intp)[:, :, None], axis=2)[:, :, 0].sum(axis=1)
    packed_payoff = u_table[j_last] - packed_cost

    # ---- non-consolidated: spread across servers (line 25) -------------
    spread = [None] * (K + 1)        # per type-prefix k = 1..K
    if not job.single_node:          # HadarE copies never span nodes
        # one stable argsort of price/throughput over every free device
        # unit; each prefix's pool is the order restricted to its types
        i_idx = np.arange(c_sp)
        valid = usable[:, None] & (i_idx[None, :] < avail[:, None])
        x_key = np.where(usable, x_types[np.minimum(rank, K - 1)], 1.0)
        ratio = np.where(valid, P / x_key[:, None], np.inf)
        flat_ratio = ratio.ravel()
        order = np.argsort(flat_ratio, kind="stable")
        key_of_flat = np.repeat(np.arange(len(ps.keys)), c_sp) \
            if c_sp else np.zeros(0, dtype=np.intp)
        sorted_key = key_of_flat[order]
        sorted_rank = rank[sorted_key]
        sorted_valid = valid.ravel()[order]
        sorted_price = P.ravel()[order] if c_sp else np.zeros(0)
        for k in range(1, K + 1):
            elig = sorted_valid & (sorted_rank < k)
            n_elig = int(elig.sum())
            if n_elig < W:
                continue
            chosen = elig & (np.cumsum(elig) <= W)
            keys_m = sorted_key[chosen]
            cost2 = float(sorted_price[chosen].sum())
            jmax = int(sorted_rank[chosen].max())
            n_servers = np.unique(ps.node_row[keys_m]).size
            if n_servers > 1:  # communication cost (lines 26-27)
                cost2 += COMM_COST_FRAC * max(u_table[jmax], 0.0) \
                    * (n_servers - 1)
            spread[k] = (u_table[jmax] - cost2, cost2, jmax, keys_m)

    # ---- pick the best candidate, in the reference enumeration order ---
    # (per fastest-type prefix: consolidated nodes in node order, then the
    # prefix's spread candidate; first maximum wins on ties)
    best_payoff = -np.inf
    best = None                      # ("pack", node_row) | ("spread", k)
    for k in range(1, K + 1):
        for h in np.nonzero(feasible & (k_first == k - 1))[0]:
            p = packed_payoff[h]
            if p > best_payoff:
                best_payoff = float(p)
                best = ("pack", int(h))
        if spread[k] is not None:
            p = spread[k][0]
            if p > best_payoff:
                best_payoff = float(p)
                best = ("spread", k)

    if best is None:
        return None
    if best_payoff <= 0 and not force:  # mu_j <= 0 -> reject (lines 29-33)
        return None

    if best[0] == "pack":
        h = best[1]
        node_id = ps.cluster.nodes[h].node_id
        alloc: Alloc = {(node_id, types[j]): int(take[h, j])
                        for j in range(K) if take[h, j] > 0}
        return Candidate(alloc, float(packed_cost[h]), best_payoff,
                         float(x_types[j_last[h]]))
    _, cost2, jmax, keys_m = spread[best[1]]
    counts = np.bincount(keys_m, minlength=len(ps.keys))
    alloc2: Alloc = {ps.keys[m]: int(c)
                     for m, c in enumerate(counts) if c}
    return Candidate(alloc2, float(cost2), best_payoff,
                     float(x_types[jmax]))


def _scan_standalone(queue: List[Job], avail0: np.ndarray,
                     gamma0: np.ndarray, ps: PriceState, now: float,
                     utility: UtilityFn, solver: Optional[str],
                     free_is_ps: bool) -> List[Optional[Candidate]]:
    """Standalone candidate per queued job against one shared state —
    one launch of K4 on the card, a per-job loop otherwise."""
    from repro_torch.core import batch_solver as bs

    if bs.use_batch(solver, len(queue), ps.device):
        dev = ps.device_view("free") if free_is_ps else None
        return bs.find_alloc_batch(queue, avail0, gamma0, ps, now, utility,
                                   avail_dev=dev)
    return [_find_alloc_arrays(j, avail0, gamma0, ps, now, utility,
                               force=False) for j in queue]


def dp_allocation(queue: List[Job],
                  free: Optional[Dict[Tuple[int, str], int]],
                  ps: PriceState, now: float, utility: UtilityFn,
                  max_exact: int = 64,
                  solver: Optional[str] = None) -> Dict[int, Candidate]:
    """Select jobs + allocations maximizing total payoff (Algorithm 2).

    Exact select/skip DP with memoization for queues up to ``max_exact``;
    longer queues are processed in payoff-density-sorted greedy order,
    keeping the cluster state as arrays and committing winners
    incrementally.  On the card the greedy commit runs through
    ``batch_solver.commit_greedy`` (conflict-free waves + kernel K5); the
    NumPy path keeps the sequential re-solve loop, its bitwise oracle."""
    from repro_torch.core import batch_solver as bs

    free_is_ps = free is None
    if len(queue) > max_exact:
        avail0 = ps.free_arr.copy() if free_is_ps else ps.free_to_arr(free)
        gamma0 = ps.gamma_arr.copy()
        if bs.use_commit(solver, len(queue), ps.device):
            dev = ps.device_view("free") if free_is_ps else None
            return bs.commit_greedy(queue, avail0, gamma0, ps, now, utility,
                                    avail_dev=dev)
        # greedy pass: highest standalone payoff first
        cands = _scan_standalone(queue, avail0, gamma0, ps, now, utility,
                                 solver, free_is_ps)
        # payoff *density* (per requested device): lets several
        # small jobs beat one large one under contention
        order = [(c.payoff / max(1, j.n_workers), j)
                 for j, c in zip(queue, cands) if c]
        order.sort(key=lambda t: -t[0])
        chosen: Dict[int, Candidate] = {}
        avail = avail0
        gamma = gamma0
        # sequential commit: re-solve each winner at the accumulated
        # state (the device commit path's bitwise equivalence oracle)
        for _, j in order:
            c = _find_alloc_arrays(j, avail, gamma, ps, now, utility,
                                   force=False)
            if c:
                chosen[j.job_id] = c
                for k, v in c.alloc.items():
                    m = ps.key_index[k]
                    avail[m] -= v
                    gamma[m] += v
        return chosen

    memo: Dict = {}

    # the all-skip spine of the DP evaluates every job once at the empty
    # server state — batch that scan in one launch and seed rec() from it
    # (identical candidates, so identical branch decisions)
    seed: Optional[List[Optional[Candidate]]] = None
    if queue and bs.use_batch(solver, len(queue), ps.device):
        avail0 = ps.free_arr.copy() if free_is_ps else ps.free_to_arr(free)
        seed = _scan_standalone(queue, avail0, ps.gamma_arr.copy(), ps,
                                now, utility, solver, free_is_ps)

    def key_of(extra: Dict) -> Tuple:
        return tuple(sorted((k, v) for k, v in extra.items() if v))

    def rec(idx: int, extra: Dict) -> Tuple[float, Dict[int, Candidate]]:
        if idx >= len(queue):
            return 0.0, {}
        k = (idx, key_of(extra))
        if k in memo:
            return memo[k]
        # branch 1: skip job (line 15)
        best_v, best_sel = rec(idx + 1, extra)
        # branch 2: allocate job (line 14)
        job = queue[idx]
        if seed is not None and not extra:
            cand = seed[idx]
        else:
            cand = find_alloc(job, free, ps, now, utility,
                              extra_gamma=extra)
        if cand is not None:
            extra2 = dict(extra)
            for kk, v in cand.alloc.items():
                extra2[kk] = extra2.get(kk, 0) + v
            v2, sel2 = rec(idx + 1, extra2)
            if cand.payoff + v2 > best_v:
                best_v = cand.payoff + v2
                best_sel = dict(sel2)
                best_sel[job.job_id] = cand
        memo[k] = (best_v, best_sel)
        return memo[k]

    _, sel = rec(0, {})
    return sel

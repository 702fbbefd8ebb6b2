"""Opt-in runtime sanitizer asserting the paper's scheduling invariants.

The port's copy of ``repro.analysis.invariants``.  Enabled by
``REPRO_SANITIZE=1`` in the environment (the same flag as the JAX
package's, so one setting switches on both) or an explicit
``sanitize=True`` argument on the hooked entry points (``PriceState``,
``dp_allocation``, ``simulate_rounds``, ``event_stream``,
``simulate_events``, ``simulate_hadare``, ``ClusterSchedulingEnv``);
``find_alloc_batch`` and the K5 commit path read the flag at each call.
Disabled (the default), the hooks reduce to a single attribute/bool
test — no per-step cost.

Invariant catalogue (check → paper constraint it enforces):

==================  =====================================================
check               paper constraint
==================  =====================================================
free-range          capacity constraint: 0 <= free_h^r <= c_h^r (the
                    primal feasibility bound on every resource key)
conservation        commit/release accounting: allocated + free == c_h^r
                    per (node, GPU-type) key — gamma_h^r tracks exactly
                    the committed occupancy
price-positive      Eq. 5: k_h^r(gamma) = U_min (U_max/U_min)^(gamma/c)
                    is strictly positive, i.e. dual prices stay feasible
price-bounds        Eqs. 6-7: 0 < U_min <= U_max (the marginal-utility
                    bounds the price function interpolates between)
payoff-positive     dual feasibility / admission gate: a committed job's
                    payoff mu_j = U_j - cost_j must be > 0 (Alg. line
                    28-32); forced backfill is exempt (work conservation)
gang-atomicity      all-or-nothing gang scheduling: a scheduled job holds
                    exactly W_j workers (sum of its allocation), never a
                    partial gang
joint-capacity      the *set* of selected candidates fits in the free
                    vector key-by-key (primal capacity across jobs)
time-monotonic      discrete-event causality: event timestamps popped
                    from the queue never decrease
gru-cru-range       GRU/CRU in [0, 1] by definition (busy GPU time /
                    available GPU time; node-level for CRU)
progress-bound      done_iters is monotone and never exceeds total_iters
                    (Eq. 1 throughput integration cannot overshoot)
sibling-disjoint    HadarE: co-trained sibling copies of one job occupy
                    distinct nodes (dedup invariant of Sec. V)
down-alloc          failure realism: no job holds devices on a node that
                    is currently down (eviction completeness under
                    dynamic capacity)
goodput-bound       goodput <= GRU: useful GPU-seconds (busy minus
                    fault losses) can never exceed busy GPU-seconds
==================  =====================================================
"""
from __future__ import annotations

import os
import reprlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

ENV_FLAG = "REPRO_SANITIZE"

_TRUTHY = {"1", "true", "yes", "on"}

# Float slack for ratio metrics (GRU/CRU accumulate float division).
_EPS = 1e-9

_repr = reprlib.Repr()
_repr.maxdict = 12
_repr.maxlist = 12
_repr.maxother = 200


class InvariantViolation(AssertionError):
    """A paper-derived invariant failed; carries a repro snapshot."""

    def __init__(self, name: str, message: str,
                 snapshot: Optional[Dict[str, Any]] = None):
        self.invariant = name
        self.snapshot = dict(snapshot or {})
        detail = ", ".join(f"{k}={_repr.repr(v)}"
                           for k, v in self.snapshot.items())
        super().__init__(
            f"[{name}] {message}" + (f" | snapshot: {detail}" if detail
                                     else ""))


def sanitize_enabled(flag: Optional[bool] = None) -> bool:
    """Resolve an explicit ``sanitize=`` argument against the env flag.

    Call once per object/run and store the bool — never per hot-loop
    iteration."""
    if flag is not None:
        return bool(flag)
    return os.environ.get(ENV_FLAG, "").strip().lower() in _TRUTHY


def violate(name: str, message: str, **snapshot) -> None:
    raise InvariantViolation(name, message, snapshot)


def _tick(check: str) -> None:
    """Count an executed invariant check on the installed observer
    (``repro_torch.obs``): one counter per check function, zero-cost when
    observability is off.  Imported here, lazily: pricing imports this
    module."""
    from repro_torch import obs as _obs
    ob = _obs.get()
    if ob.enabled:
        ob.count("invariant_checks." + check)


# --------------------------------------------------------------------------
# PriceState-level checks (duck-typed: no core import, pricing imports
# this module)
# --------------------------------------------------------------------------

def check_price_state(ps, context: str = "") -> None:
    """free-range / conservation / price-bounds on a PriceState."""
    _tick("price_state")
    free = np.asarray(ps.free_arr, dtype=float)
    cap = np.asarray(ps.cap_arr, dtype=float)
    gamma = np.asarray(ps.gamma_arr, dtype=float)
    if free.size and float(free.min()) < 0.0:
        i = int(free.argmin())
        violate("free-range", f"free_arr below 0 {context}".strip(),
                key=ps.keys[i], free=float(free[i]), cap=float(cap[i]))
    over = free - cap
    if over.size and float(over.max()) > 0.0:
        i = int(over.argmax())
        violate("free-range", f"free_arr above capacity {context}".strip(),
                key=ps.keys[i], free=float(free[i]), cap=float(cap[i]))
    if gamma.size and float(gamma.min()) < 0.0:
        i = int(gamma.argmin())
        violate("conservation", f"gamma_arr negative {context}".strip(),
                key=ps.keys[i], gamma=float(gamma[i]))
    # Conservation only holds while gamma has been driven purely by
    # refresh/commit/release; direct gamma-dict writes (a legitimate API
    # for replaying externally computed occupancy) clear the flag.
    if getattr(ps, "_conserved", False):
        resid = np.abs(gamma + free - cap)
        if resid.size and float(resid.max()) > 1e-6:
            i = int(resid.argmax())
            violate("conservation",
                    f"allocated + free != capacity {context}".strip(),
                    key=ps.keys[i], gamma=float(gamma[i]),
                    free=float(free[i]), cap=float(cap[i]))
    umin = np.asarray(ps.umin_arr, dtype=float)
    umax = np.asarray(ps.umax_arr, dtype=float)
    if umin.size and float(umin.min()) <= 0.0:
        i = int(umin.argmin())
        violate("price-bounds", "U_min must be > 0 (Eq. 6)",
                key=ps.keys[i], umin=float(umin[i]))
    if umin.size and float((umax - umin).min()) < 0.0:
        i = int((umax - umin).argmin())
        violate("price-bounds", "U_max < U_min (Eqs. 6-7)",
                key=ps.keys[i], umin=float(umin[i]), umax=float(umax[i]))


def check_commit_amounts(ps, alloc: Dict[Tuple[int, str], int],
                         op: str) -> None:
    """Per-key sanity of a commit/release delta before it is applied."""
    _tick("commit_amounts")
    for key, count in alloc.items():
        if count < 0:
            violate("free-range", f"{op} with negative count", key=key,
                    count=count)
        if key not in ps.key_index:
            violate("free-range", f"{op} on unknown resource key", key=key,
                    count=count)


# --------------------------------------------------------------------------
# Candidate/selection checks (dp_allocation, find_alloc_batch)
# --------------------------------------------------------------------------

def check_candidate(job_id, n_workers: int, alloc, payoff: float,
                    cost: float, forced: bool = False,
                    context: str = "") -> None:
    _tick("candidate")
    total = 0
    for key, count in alloc.items():
        if count <= 0:
            violate("gang-atomicity",
                    f"non-positive worker count in allocation {context}",
                    job=job_id, key=key, count=count)
        total += int(count)
    if total != int(n_workers):
        violate("gang-atomicity",
                f"partial gang: allocation holds {total} of "
                f"{n_workers} workers {context}", job=job_id,
                alloc=dict(alloc))
    if cost < 0.0:
        violate("price-positive",
                f"negative allocation cost (Eq. 5 prices are > 0) "
                f"{context}", job=job_id, cost=cost)
    if not forced and payoff <= 0.0:
        violate("payoff-positive",
                f"committed job has non-positive payoff mu_j "
                f"(dual-feasibility admission gate) {context}",
                job=job_id, payoff=payoff, cost=cost)


def check_selection(selection, free: Dict[Tuple[int, str], float],
                    context: str = "") -> None:
    """joint-capacity over a set of selected (job_id -> Candidate)."""
    _tick("selection")
    used: Dict[Tuple[int, str], float] = {}
    for job_id, cand in selection.items():
        for key, count in cand.alloc.items():
            used[key] = used.get(key, 0.0) + count
    for key, total in used.items():
        avail = float(free.get(key, 0.0))
        if total > avail + 1e-9:
            violate("joint-capacity",
                    f"selected candidates oversubscribe a resource key "
                    f"{context}", key=key, used=total, free=avail)


# --------------------------------------------------------------------------
# Engine-level checks (simulate_rounds / simulate_events /
# simulate_hadare)
# --------------------------------------------------------------------------

def check_cluster_allocs(jobs, capacity: Dict[Tuple[int, str], int],
                         t: float, engine: str) -> None:
    """gang-atomicity + conservation over the live allocation map."""
    _tick("cluster_allocs")
    used: Dict[Tuple[int, str], int] = {}
    for job in jobs:
        alloc = getattr(job, "alloc", None)
        if not alloc:
            continue
        total = 0
        for key, count in alloc.items():
            if count <= 0:
                violate("gang-atomicity",
                        "non-positive worker count in live allocation",
                        engine=engine, t=t, job=job.job_id, key=key,
                        count=count)
            used[key] = used.get(key, 0) + int(count)
            total += int(count)
        if total != int(job.n_workers):
            violate("gang-atomicity",
                    "live allocation is a partial gang",
                    engine=engine, t=t, job=job.job_id,
                    n_workers=job.n_workers, held=total)
    for key, total in used.items():
        cap = int(capacity.get(key, 0))
        if total > cap:
            violate("conservation",
                    "allocated exceeds capacity on a resource key "
                    "(allocated + free == capacity violated)",
                    engine=engine, t=t, key=key, allocated=total,
                    capacity=cap)


def check_progress(job, t: float, engine: str,
                   prev_done: Optional[float] = None) -> None:
    _tick("progress")
    done = float(job.done_iters)
    total = float(job.total_iters)
    if done < -_EPS or done > total * (1.0 + 1e-9) + 1e-6:
        violate("progress-bound",
                "done_iters outside [0, total_iters]",
                engine=engine, t=t, job=job.job_id, done=done, total=total)
    if prev_done is not None and done < prev_done - 1e-9:
        violate("progress-bound", "done_iters decreased",
                engine=engine, t=t, job=job.job_id, done=done,
                prev=prev_done)


def check_utilization(gru: float, cru: float, t: float,
                      engine: str) -> None:
    _tick("utilization")
    if not (-_EPS <= gru <= 1.0 + _EPS):
        violate("gru-cru-range", "GRU outside [0, 1]",
                engine=engine, t=t, gru=gru)
    if not (-_EPS <= cru <= 1.0 + _EPS):
        violate("gru-cru-range", "CRU outside [0, 1]",
                engine=engine, t=t, cru=cru)


def check_monotonic(t_new: float, t_prev: float, engine: str,
                    what: str = "event time") -> None:
    _tick("monotonic")
    if t_new < t_prev - 1e-9:
        violate("time-monotonic", f"{what} moved backwards",
                engine=engine, t_new=t_new, t_prev=t_prev)


def check_down_allocs(jobs, down_nodes, t: float, engine: str) -> None:
    """down-alloc: after fault processing, no live allocation touches a
    down node (the graceful-degradation eviction must be complete)."""
    _tick("down_allocs")
    if not down_nodes:
        return
    for job in jobs:
        alloc = getattr(job, "alloc", None)
        if not alloc:
            continue
        for (node, _gpu), count in alloc.items():
            if count > 0 and node in down_nodes:
                violate("down-alloc",
                        "job allocated on a down node",
                        engine=engine, t=t, job=job.job_id, node=node,
                        down=sorted(down_nodes))


def check_goodput(goodput: float, gru: float, engine: str) -> None:
    """goodput-bound: 0 <= goodput <= overall GRU."""
    _tick("goodput")
    if goodput < -_EPS:
        violate("goodput-bound", "goodput negative",
                engine=engine, goodput=goodput)
    if goodput > gru + _EPS:
        violate("goodput-bound",
                "goodput exceeds GRU (useful work cannot exceed busy "
                "work)", engine=engine, goodput=goodput, gru=gru)


def check_sibling_nodes(parent_id, copies, t: float) -> None:
    """HadarE sibling-disjointness: each live copy of a job on its own
    node set, no node shared between siblings."""
    _tick("sibling_nodes")
    seen: Dict[int, Any] = {}
    for copy in copies:
        alloc = getattr(copy, "alloc", None)
        if not alloc:
            continue
        for (node, _gpu), _count in alloc.items():
            if node in seen and seen[node] is not copy:
                violate("sibling-disjoint",
                        "sibling copies share a node",
                        parent=parent_id, node=node, t=t,
                        copies=[c.job_id for c in copies])
            seen[node] = copy

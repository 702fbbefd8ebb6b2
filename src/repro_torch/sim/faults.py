"""Fault injection for the simulation engines.

The port's copy of ``repro.sim.faults``: the same windows, draws and
eviction choices, from the same per-node NumPy ``RandomState`` streams.

Real heterogeneous clusters lose nodes (hardware MTBF) and spot
capacity (provider reclaim); the Helios characterization shows failures
dominate wasted GPU-hours in production DL datacenters.  This module
provides the failure-schedule side of that realism:

- :class:`FaultWindow` / :class:`FailureTrace` — validated, sorted
  ``(node, fail_time, recover_time, kind)`` windows.  An exogenous
  input to the engines, never invalidated or predicted.
- :class:`FailureModel` — seeded generative model: exponential MTBF
  (scalar or per-GPU-type), spot-reclaim rate for designated spot
  nodes, and configurable recovery-time distributions.  All draws come
  from per-node RNG streams derived from ``(seed, node_id)``, so a
  schedule restricted to a pod's nodes is bitwise identical to
  restricting the full-cluster schedule — pods fail independently by
  construction.
- :class:`FaultState` — engine-side runtime bookkeeping: the down-node
  set, cached up-capacity cluster views (one object per distinct
  down-set so persistent ``PriceState`` geometry checks hit on
  identity), live capacity, and round-engine quantized advancement.
- :func:`select_evictions` — graceful degradation: when capacity drops
  below committed allocations, victims are chosen in reverse payoff
  order (lowest marginal utility first) until the remaining
  allocations fit.
- :func:`rollback_point` — checkpoint-interval cost model: progress
  past the last checkpoint is lost on eviction, extending the flat
  ``restart_penalty`` into a ``restart_penalty + lost_progress``
  charge.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Dict, FrozenSet, Iterable, List, Optional, Sequence, Set,
                    Tuple, Union)

import numpy as np

from repro_torch.core.types import Cluster, Job, alloc_size

#: fault-window kinds
KIND_FAIL = "fail"
KIND_SPOT = "spot"
_KINDS = (KIND_FAIL, KIND_SPOT)

#: default checkpoint interval (seconds).  Jobs snapshot state this
#: often while progressing; on eviction, progress past the most recent
#: snapshot is rolled back.
CHECKPOINT_INTERVAL = 600.0

#: default schedule horizon for FailureModel.sample (seconds)
DEFAULT_HORIZON = 7 * 24 * 3600.0


@dataclasses.dataclass(frozen=True)
class FaultWindow:
    """One outage: ``node_id`` is down over ``[fail_time, recover_time)``.

    ``recover_time = inf`` means the node never comes back.  ``kind``
    distinguishes hardware failures from spot reclaims — eviction
    semantics are identical, accounting is separate."""
    node_id: int
    fail_time: float
    recover_time: float = math.inf
    kind: str = KIND_FAIL


class FailureTrace:
    """Validated, deterministically-sorted collection of fault windows.

    Validation mirrors the job-trace loader's rigor: negative times,
    inverted windows, unknown kinds, per-node *overlapping* windows,
    and (when a cluster is supplied) unknown node ids are all rejected
    with a ``ValueError`` naming the offending window.  Back-to-back
    windows (recover at t, next failure at t) are allowed — the event
    tie-order (NODE_RECOVER before NODE_FAIL) keeps them well-defined.
    """

    def __init__(self, windows: Iterable[Union[FaultWindow, tuple]],
                 cluster: Optional[Cluster] = None):
        ws: List[FaultWindow] = []
        for w in windows:
            if not isinstance(w, FaultWindow):
                w = FaultWindow(*w)
            ws.append(w)
        known = (None if cluster is None
                 else {n.node_id for n in cluster.nodes})
        per_node: Dict[int, List[FaultWindow]] = {}
        for w in ws:
            if w.kind not in _KINDS:
                raise ValueError(
                    f"fault window {w}: unknown kind {w.kind!r} "
                    f"(expected one of {_KINDS})")
            if not (w.fail_time >= 0.0):
                raise ValueError(
                    f"fault window {w}: fail_time must be >= 0")
            if not (w.recover_time > w.fail_time):
                raise ValueError(
                    f"fault window {w}: recover_time must be > fail_time")
            if known is not None and w.node_id not in known:
                raise ValueError(
                    f"fault window {w}: unknown node {w.node_id} "
                    f"(cluster has {len(known)} nodes)")
            per_node.setdefault(w.node_id, []).append(w)
        for node_id in sorted(per_node):
            lst = sorted(per_node[node_id],
                         key=lambda w: (w.fail_time, w.recover_time))
            for a, b in zip(lst, lst[1:]):
                if b.fail_time < a.recover_time:
                    raise ValueError(
                        f"overlapping fault windows on node {node_id}: "
                        f"{a} and {b}")
        self.windows: List[FaultWindow] = sorted(
            ws, key=lambda w: (w.fail_time, w.node_id, w.recover_time))

    def __len__(self) -> int:
        return len(self.windows)

    def __iter__(self):
        return iter(self.windows)

    def __eq__(self, other) -> bool:
        return (isinstance(other, FailureTrace)
                and self.windows == other.windows)

    def restrict(self, node_ids: Iterable[int]) -> "FailureTrace":
        """Sub-trace touching only ``node_ids`` (e.g. one pod's nodes).

        Because FailureModel draws from per-node streams, restricting
        a sampled schedule equals sampling the restricted cluster —
        sibling pods see byte-identical schedules either way."""
        keep = set(node_ids)
        return FailureTrace([w for w in self.windows if w.node_id in keep])


class FailureModel:
    """Seeded generative failure model.

    Parameters
    ----------
    mtbf_hours:
        Mean time between failures for non-spot nodes.  Either a scalar
        applied to every node, or a ``{gpu_type: hours}`` dict — a
        node's MTBF is the *minimum* over its GPU types (its weakest
        hardware fails first); nodes whose types are absent from the
        dict never hard-fail.
    recovery_s / recovery_dist:
        Mean repair time and its distribution: ``"fixed"`` (exactly the
        mean), ``"uniform"`` (0.5x-1.5x the mean), or ``"exponential"``.
    spot_nodes / spot_frac:
        Spot capacity: either an explicit set of node ids, or a
        per-node Bernoulli fraction drawn from the node's stream.
        Spot nodes are reclaimed at ``spot_reclaim_hours`` MTBF and
        return after ``spot_recovery_s`` (same ``recovery_dist``),
        instead of the hardware MTBF schedule.
    checkpoint_interval:
        Seconds between job checkpoints; the engines roll evicted jobs
        back to the last multiple (see :func:`rollback_point`).
    seed:
        Explicit schedule seed.  Every draw comes from a per-node
        ``RandomState`` stream keyed on ``(seed, node_id)``; no global
        RNG state is touched.
    """

    def __init__(self,
                 mtbf_hours: Union[float, Dict[str, float]] = 168.0,
                 recovery_s: float = 900.0,
                 recovery_dist: str = "fixed",
                 spot_nodes: Optional[Iterable[int]] = None,
                 spot_frac: float = 0.0,
                 spot_reclaim_hours: float = 24.0,
                 spot_recovery_s: float = 300.0,
                 checkpoint_interval: float = CHECKPOINT_INTERVAL,
                 horizon: float = DEFAULT_HORIZON,
                 seed: int = 0):
        if isinstance(mtbf_hours, dict):
            for k, v in sorted(mtbf_hours.items()):
                if not v > 0:
                    raise ValueError(f"mtbf_hours[{k!r}] must be > 0")
        elif not mtbf_hours > 0:
            raise ValueError("mtbf_hours must be > 0")
        if recovery_dist not in ("fixed", "uniform", "exponential"):
            raise ValueError(f"unknown recovery_dist {recovery_dist!r}")
        if not spot_reclaim_hours > 0:
            raise ValueError("spot_reclaim_hours must be > 0")
        if not (0.0 <= spot_frac <= 1.0):
            raise ValueError("spot_frac must be in [0, 1]")
        self.mtbf_hours = mtbf_hours
        self.recovery_s = float(recovery_s)
        self.recovery_dist = recovery_dist
        self.spot_nodes = (None if spot_nodes is None
                           else frozenset(int(n) for n in spot_nodes))
        self.spot_frac = float(spot_frac)
        self.spot_reclaim_hours = float(spot_reclaim_hours)
        self.spot_recovery_s = float(spot_recovery_s)
        self.checkpoint_interval = float(checkpoint_interval)
        self.horizon = float(horizon)
        self.seed = int(seed)

    def _node_rng(self, node_id: int) -> np.random.RandomState:
        # splitmix-style integer mix: independent stream per (seed, node),
        # stable across cluster compositions (no hash(), no global state)
        mix = (self.seed * 1000003 + int(node_id) * 7919 + 12345) % (2 ** 32)
        return np.random.RandomState(mix)

    def _node_mtbf_s(self, node) -> float:
        if isinstance(self.mtbf_hours, dict):
            hours = [self.mtbf_hours[r] for r in sorted(node.gpus)
                     if r in self.mtbf_hours]
            if not hours:
                return math.inf
            return min(hours) * 3600.0
        return float(self.mtbf_hours) * 3600.0

    def _draw_recovery(self, rng: np.random.RandomState,
                       mean: float) -> float:
        if self.recovery_dist == "fixed":
            dur = mean
        elif self.recovery_dist == "uniform":
            dur = float(rng.uniform(0.5, 1.5)) * mean
        else:
            dur = float(rng.exponential(mean))
        return max(1e-9, dur)

    def sample(self, cluster: Cluster,
               horizon: Optional[float] = None) -> FailureTrace:
        """Draw a full failure schedule over ``[0, horizon)``."""
        horizon = self.horizon if horizon is None else float(horizon)
        windows: List[FaultWindow] = []
        for node in cluster.nodes:
            rng = self._node_rng(node.node_id)
            if self.spot_nodes is not None:
                is_spot = node.node_id in self.spot_nodes
            elif self.spot_frac > 0.0:
                is_spot = bool(rng.uniform() < self.spot_frac)
            else:
                is_spot = False
            if is_spot:
                mtbf_s = self.spot_reclaim_hours * 3600.0
                rec_mean = self.spot_recovery_s
                kind = KIND_SPOT
            else:
                mtbf_s = self._node_mtbf_s(node)
                rec_mean = self.recovery_s
                kind = KIND_FAIL
            if not math.isfinite(mtbf_s):
                continue
            t = 0.0
            while True:
                t += float(rng.exponential(mtbf_s))
                if t >= horizon:
                    break
                dur = self._draw_recovery(rng, rec_mean)
                windows.append(FaultWindow(node.node_id, t, t + dur, kind))
                t += dur
        return FailureTrace(windows, cluster)


def resolve_faults(faults, cluster: Cluster) -> Optional[FailureTrace]:
    """Normalize an engine ``faults=`` argument to a FailureTrace.

    Accepts ``None``, a :class:`FailureModel` (sampled against the
    cluster), a :class:`FailureTrace` (re-validated against the
    cluster so unknown nodes are caught at the engine boundary), or an
    iterable of windows/tuples."""
    if faults is None:
        return None
    if isinstance(faults, FailureModel):
        return faults.sample(cluster)
    if isinstance(faults, FailureTrace):
        return FailureTrace(faults.windows, cluster)
    return FailureTrace(faults, cluster)


def resolve_checkpoint_interval(arg: Optional[float], faults) -> float:
    """Engine-side resolution: explicit arg > model knob > default."""
    if arg is not None:
        return float(arg)
    if isinstance(faults, FailureModel):
        return faults.checkpoint_interval
    return CHECKPOINT_INTERVAL


def rollback_point(done0: float, done_now: float, rate_w: float,
                   run_seconds: float, interval: float) -> float:
    """Iteration count retained after an eviction.

    The job began progressing ``run_seconds`` ago from ``done0``
    iterations at aggregate rate ``rate_w`` (iters/s across the gang),
    checkpointing every ``interval`` seconds of progress; it holds
    ``done_now`` accrued iterations at eviction time.  Returns the
    last checkpointed count: ``done0 + rate_w * k * interval`` for the
    largest whole ``k`` that fits in ``run_seconds``.  ``interval <= 0``
    models continuous checkpointing (nothing lost)."""
    if rate_w <= 0.0 or run_seconds <= 0.0:
        return done_now
    if interval <= 0.0:
        return done_now
    k = math.floor(run_seconds / interval + 1e-9)
    retained = done0 + rate_w * k * interval
    return min(done_now, max(done0, retained))


class FaultState:
    """Engine-side fault bookkeeping.

    Tracks the set of down nodes, exposes the up-capacity cluster view
    (cached per distinct down-set so a persistent scheduler's
    ``PriceState.matches()`` identity check keeps hitting between
    faults), and serves the round engines' quantized advancement."""

    def __init__(self, trace: FailureTrace, cluster: Cluster):
        self.trace = trace
        self.cluster = cluster
        self.down: Set[int] = set()
        self._views: Dict[FrozenSet[int], Cluster] = {}
        self._caps: Dict[FrozenSet[int], Dict[Tuple[int, str], int]] = {}
        self._full_cap: Dict[Tuple[int, str], int] = {
            (n.node_id, r): int(c)
            for n in cluster.nodes for r, c in sorted(n.gpus.items())}
        self._recover_at: Dict[Tuple[int, float], float] = {
            (w.node_id, w.fail_time): w.recover_time for w in trace}
        # all distinct window boundaries, for next_change()
        bounds: Set[float] = set()
        for w in trace:
            bounds.add(w.fail_time)
            if math.isfinite(w.recover_time):
                bounds.add(w.recover_time)
        self._bounds: List[float] = sorted(bounds)

    # -- event-engine interface ------------------------------------------

    def fail(self, node_id: int) -> None:
        self.down.add(node_id)

    def recover(self, node_id: int) -> None:
        self.down.discard(node_id)

    def recover_time(self, node_id: int, fail_time: float) -> float:
        """Scheduled recovery for the window failing at ``fail_time``."""
        return self._recover_at.get((node_id, fail_time), math.inf)

    def any_up(self) -> bool:
        return len(self.down) < len(self.cluster.nodes)

    def active_window(self, node_id: int,
                      t: float) -> Optional[FaultWindow]:
        """The window keeping ``node_id`` down at ``t``, if any."""
        for w in self.trace:
            if (w.node_id == node_id
                    and w.fail_time <= t < w.recover_time):
                return w
        return None

    def up_counts(self) -> Tuple[int, int]:
        """(live GPUs, live nodes) under the current down-set."""
        gpus = 0
        nodes = 0
        for n in self.cluster.nodes:
            if n.node_id in self.down:
                continue
            nodes += 1
            gpus += sum(c for _r, c in sorted(n.gpus.items()))
        return gpus, nodes

    def view(self) -> Cluster:
        """Cluster restricted to up nodes; one cached object per
        down-set, and the original object when nothing is down."""
        if not self.down:
            return self.cluster
        key = frozenset(self.down)
        view = self._views.get(key)
        if view is None:
            view = Cluster([n for n in self.cluster.nodes
                            if n.node_id not in self.down])
            self._views[key] = view
        return view

    def live_capacity(self) -> Dict[Tuple[int, str], int]:
        """(node, gpu_type) -> live count; down nodes contribute 0."""
        if not self.down:
            return self._full_cap
        key = frozenset(self.down)
        cap = self._caps.get(key)
        if cap is None:
            cap = {k: (0 if k[0] in self.down else c)
                   for k, c in self._full_cap.items()}
            self._caps[key] = cap
        return cap

    # -- round-engine quantized interface --------------------------------

    def advance_to(self, t: float) -> bool:
        """Recompute the down-set as of time ``t`` (round-quantized
        semantics: a window is active while ``fail <= t < recover``).
        Returns True when the down-set changed."""
        now = {w.node_id for w in self.trace
               if w.fail_time <= t < w.recover_time}
        if now == self.down:
            return False
        self.down = now
        return True

    def next_change(self, t: float) -> float:
        """Earliest window boundary strictly after ``t`` (inf if none).
        The round engines bound their steady-state fast-forward by this
        so a skip never jumps over a failure or recovery."""
        for b in self._bounds:
            if b > t:
                return b
        return math.inf


def select_evictions(jobs: Sequence[Job],
                     live_cap: Dict[Tuple[int, str], int]) -> List[Job]:
    """Graceful degradation: pick eviction victims until the remaining
    allocations fit inside ``live_cap``.

    Victims are chosen in reverse payoff order — lowest marginal
    utility first, proxied by the achieved aggregate throughput
    ``bottleneck_rate(alloc) * alloc_size(alloc)``, ties broken by
    job id.  Gangs are atomic: any key on a down node evicts the whole
    allocation, freeing its siblings too."""
    running = [j for j in jobs if j.alloc and not j.is_done()]
    used: Dict[Tuple[int, str], int] = {}
    for j in running:
        for k, c in sorted(j.alloc.items()):
            used[k] = used.get(k, 0) + int(c)
    evicted: List[Job] = []
    remaining = list(running)
    while True:
        over = {k for k, u in sorted(used.items())
                if u > int(live_cap.get(k, 0))}
        if not over:
            break
        cands = [j for j in remaining
                 if any(k in over for k in sorted(j.alloc))]
        if not cands:        # oversubscription not attributable: bail
            break
        victim = min(
            cands,
            key=lambda j: (j.bottleneck_rate(j.alloc) * alloc_size(j.alloc),
                           j.job_id))
        remaining.remove(victim)
        for k, c in sorted(victim.alloc.items()):
            used[k] = used.get(k, 0) - int(c)
            if used[k] <= 0:
                used.pop(k)
        evicted.append(victim)
    return evicted

"""The primal-dual price function (paper Eqs. 5-7) and its bookkeeping.

k_h^r(gamma) = U_min^r * (U_max^r / U_min^r) ** (gamma / c_h^r)

starts low enough to admit any job (k = U_min at gamma=0) and grows
exponentially to U_max as the server fills, blocking low-utility jobs.
alpha = max_r(1, ln(Umax/Umin)) gives the 2*alpha competitive bound
(Theorem 2).

The port's copy of ``repro.core.pricing``, with the observability and
sanitizer hooks left out (they only record or check).  Every (node,
gpu_type) pair of the cluster is a *key* (in ``Cluster.free_map``
order); capacity, U-bounds, gamma and the free-device vector live in
aligned NumPy arrays.  ``gamma`` stays a dict that writes through to
``gamma_arr``.  ``device_view()`` keeps a cached tensor of each state
vector on the card for the batched solver (``core.batch_solver``),
re-uploaded only after a mutation marks it dirty.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.types import Cluster, Job
from repro_torch.core.utility import UtilityFn, effective_throughput
from repro_torch.device import DeviceLike, resolve_device


class _GammaDict(dict):
    """gamma as a dict, write-through-synced to ``PriceState.gamma_arr``."""

    def __init__(self, ps: "PriceState"):
        super().__init__()
        self._ps = ps

    def _sync(self, key, value) -> None:
        idx = self._ps.key_index.get(key)
        if idx is not None:
            self._ps.gamma_arr[idx] = value
            self._ps._touch("gamma")

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self._sync(key, value)

    def __delitem__(self, key):
        super().__delitem__(key)
        self._sync(key, 0)

    def update(self, *args, **kwargs):
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def pop(self, key, *default):
        had = key in self
        out = super().pop(key, *default)
        if had:
            self._sync(key, 0)
        return out

    def popitem(self):
        key, value = super().popitem()
        self._sync(key, 0)
        return key, value

    def __ior__(self, other):
        self.update(other)
        return self

    def clear(self):
        super().clear()
        self._ps.gamma_arr[:] = 0
        self._ps._touch("gamma")


class PriceState:
    """``device`` is where ``device_view`` puts its tensors: the card
    unless the caller asks for the CPU (resolved at the first view, so a
    NumPy-only scheduler never needs CUDA)."""

    def __init__(self, cluster: Cluster, jobs: List[Job], horizon: float,
                 utility: UtilityFn = effective_throughput,
                 now: float = 0.0, device: DeviceLike = None):
        self.cluster = cluster
        self.utility = utility
        self.horizon = horizon
        self.device = device
        self.u_max: Dict[str, float] = {}
        self.u_min: Dict[str, float] = {}
        self._compute_bounds(jobs, now)
        self._build_arrays()
        self.gamma: Dict[Tuple[int, str], int] = _GammaDict(self)

    # ---- Eqs. 6-7 ------------------------------------------------------
    def _compute_bounds(self, jobs: List[Job], now: float) -> None:
        types = self.cluster.gpu_types
        cap_total = sum(self.cluster.capacity().values())
        jobs = [j for j in jobs if j.throughput]
        if not jobs:
            for r in types:
                self.u_max[r] = 1.0
                self.u_min[r] = 1.0 / math.e
            return
        # eta: scaling factor bounding the initial dual objective; from the
        # proof's requirement 1/eta <= t_max * sum_r w / sum_h sum_r c.
        eta = max(cap_total / max(j.t_max() * j.n_workers, 1e-9)
                  for j in jobs)
        eta = max(eta, 1.0)
        # the per-job best/worst scan is type-invariant, so it runs once
        best, worst = 0.0, float("inf")
        for j in jobs:
            u_best = self.utility(j, max(j.t_min(), 1e-9))
            best = max(best, u_best / max(j.n_workers, 1))
            u_floor = self.utility(j, max(self.horizon - j.arrival,
                                          j.t_min(), 1e-9))
            worst = min(worst,
                        u_floor / (j.t_max() * j.n_workers))
        for r in types:
            self.u_max[r] = max(best, 1e-12)
            self.u_min[r] = max(min(worst / (4.0 * eta),
                                    self.u_max[r] / math.e), 1e-15)

    # ---- vectorized engine state ---------------------------------------
    def _build_arrays(self) -> None:
        nodes = self.cluster.nodes
        type_col = {r: i for i, r in enumerate(self.cluster.gpu_types)}
        # key order == Cluster.free_map insertion order (node, then each
        # node's own gpus order) — spread-candidate tie-breaking relies on it
        self.keys: List[Tuple[int, str]] = []
        caps, rows, cols = [], [], []
        for row, n in enumerate(nodes):
            for r, c in n.gpus.items():
                self.keys.append((n.node_id, r))
                caps.append(float(c))
                rows.append(row)
                cols.append(type_col[r])
        self.key_index = {k: i for i, k in enumerate(self.keys)}
        self.cap_arr = np.array(caps)
        self.node_row = np.array(rows, dtype=np.intp)   # row in `nodes`
        self.type_col = np.array(cols, dtype=np.intp)   # col in gpu_types
        self.n_node_rows = len(nodes)
        self.umin_arr = np.array([self.u_min[r] for (_, r) in self.keys])
        self.umax_arr = np.array([self.u_max[r] for (_, r) in self.keys])
        self.q_arr = self.umax_arr / self.umin_arr
        self.gamma_arr = np.zeros(len(self.keys))
        # persistent free-device vector, maintained by commit()/release()
        self.free_arr = self.cap_arr.copy()
        self._cap_by_key = dict(zip(self.keys, (int(c) for c in caps)))
        self._geometry = self._fingerprint(self.cluster)
        # cached device tensors (see device_view); everything dirty until
        # the first upload
        self._dev: Dict[str, torch.Tensor] = {}
        self._dirty = set(self._VIEWS)

    # views exposed to the batched solver; name -> backing array attribute
    _VIEWS = {"gamma": "gamma_arr", "free": "free_arr", "cap": "cap_arr",
              "umin": "umin_arr", "umax": "umax_arr", "q": "q_arr",
              "node_row": "node_row", "type_col": "type_col"}

    def _touch(self, *names: str) -> None:
        """Mark device views stale after a host-array mutation."""
        self._dirty.update(names)

    @staticmethod
    def _fingerprint(cluster: Cluster):
        return tuple((n.node_id, tuple(n.gpus.items()))
                     for n in cluster.nodes)

    def matches(self, cluster: Cluster) -> bool:
        """True iff this state's key arrays are still valid for
        ``cluster`` — same object AND unchanged node/GPU geometry, so
        long-lived schedulers detect in-place cluster mutation (node
        failure, capacity change) and rebuild instead of pricing
        against stale capacity."""
        return (self.cluster is cluster
                and self._geometry == self._fingerprint(cluster))

    def device_view(self, name: str) -> torch.Tensor:
        """Cached device tensor of state vector ``name``: float64 for the
        float vectors, int32 for the index vectors ``node_row`` and
        ``type_col`` (the kernels' index type).

        The tensor is re-uploaded only when the backing host array was
        mutated since the last call (write-through dirty flag), so a run
        of consultations that only commit/release a few allocations pays
        O(mutations) transfers, not O(calls)."""
        if name not in self._VIEWS:
            raise KeyError(f"no device view named {name!r}")
        if name in self._dirty or name not in self._dev:
            arr = getattr(self, self._VIEWS[name])
            dtype = (torch.int32 if arr.dtype.kind in "iu"
                     else torch.float64)
            self._dev[name] = torch.tensor(
                arr, dtype=dtype, device=resolve_device(self.device))
            self._dirty.discard(name)
        return self._dev[name]

    def refresh(self, jobs: List[Job], now: float) -> None:
        """Re-prime this instance for a new scheduling point, in place.

        Equivalent to constructing ``PriceState(cluster, jobs, horizon,
        utility, now)`` but without rebuilding the key arrays: U-bounds
        are recomputed for the new active set, gamma and the free vector
        reset, and every array object keeps its identity."""
        self.u_max.clear()
        self.u_min.clear()
        self._compute_bounds(jobs, now)
        self.umin_arr[:] = [self.u_min[r] for (_, r) in self.keys]
        self.umax_arr[:] = [self.u_max[r] for (_, r) in self.keys]
        np.divide(self.umax_arr, self.umin_arr, out=self.q_arr)
        self.gamma.clear()              # zeroes gamma_arr in place
        self.free_arr[:] = self.cap_arr
        self._touch("umin", "umax", "q", "free")

    def free_to_arr(self, free: Dict[Tuple[int, str], int]) -> np.ndarray:
        """Project a free-count dict onto the key axis."""
        return np.array([float(free.get(k, 0)) for k in self.keys])

    def unit_prices(self, gamma_arr: np.ndarray,
                    max_units: int) -> np.ndarray:
        """unit[m, i] = marginal price of the (i+1)-th extra device on key
        m given occupancy ``gamma_arr`` — Eq. 5 for a whole cluster at
        once.  Shape (M, max_units)."""
        i = np.arange(max_units)
        expo = ((gamma_arr[:, None] + i[None, :])
                / np.maximum(self.cap_arr, 1.0)[:, None])
        return self.umin_arr[:, None] * self.q_arr[:, None] ** expo

    # ---- Eq. 5 ----------------------------------------------------------
    def price(self, node_id: int, gpu_type: str, cap: int,
              gamma_override: int = None) -> float:
        g = (self.gamma.get((node_id, gpu_type), 0)
             if gamma_override is None else gamma_override)
        umax, umin = self.u_max[gpu_type], self.u_min[gpu_type]
        return umin * (umax / umin) ** (g / max(cap, 1))

    def alpha(self) -> float:
        """Theorem 2 competitive-ratio constant."""
        return max([1.0] + [math.log(self.u_max[r] / self.u_min[r])
                            for r in self.u_max])

    def commit(self, alloc: Dict[Tuple[int, str], int]) -> None:
        for key, c in alloc.items():
            self.gamma[key] = self.gamma.get(key, 0) + c
            m = self.key_index.get(key)
            if m is not None:
                self.free_arr[m] -= c
        self._touch("free")

    def commit_batch(self, allocs) -> None:
        """Commit a whole wave of winner allocations in one aggregated
        free/gamma delta; the same as one ``commit`` per allocation
        (integer adds commute)."""
        allocs = [a for a in allocs if a]
        if not allocs:
            return
        total: Dict[Tuple[int, str], int] = {}
        for alloc in allocs:
            for key, c in alloc.items():
                total[key] = total.get(key, 0) + c
        self.commit(total)

    def release(self, alloc: Dict[Tuple[int, str], int]) -> None:
        for key, c in alloc.items():
            self.gamma[key] = max(0, self.gamma.get(key, 0) - c)
            m = self.key_index.get(key)
            if m is not None:
                self.free_arr[m] = min(self.cap_arr[m],
                                       self.free_arr[m] + c)
        self._touch("free")

    def snapshot(self) -> Tuple:
        return tuple(sorted((k, v) for k, v in self.gamma.items() if v))

"""Gym-style cluster-scheduling environment over the event engine.

The port's copy of ``repro.env.env``.  The observation is host NumPy:
the price vector comes from a port ``PriceState`` priced on the host
(``unit_prices``), never from a device view, so an env driven by a NumPy
policy runs on a machine without a card.

:class:`ClusterSchedulingEnv` wraps ``repro_torch.sim.engine.event_stream``
(the co-routine form of ``simulate_events``) as its transition kernel:
``reset()`` opens a fresh episode over a cloned job trace, each
``step(action)`` answers one scheduling decision point with a desired
allocation map, and the episode terminates when the trace drains (the
final ``EventSimResult`` lands in ``info["result"]``).  The API is
duck-typed Gymnasium — ``reset() -> (obs, info)``, ``step(action) ->
(obs, reward, terminated, truncated, info)`` — with **no hard
Gymnasium dependency** (the DL2 / DRL_Scheduler precedent: an RL-facing
step/observe interface over a discrete-event simulator).

Because the env and ``simulate_events`` drive the *same* generator
kernel, a policy stepped through the env replays bitwise the decisions
and metrics it would produce natively; ``run_policy`` drives any
``repro_torch.core.schedulers.Scheduler`` through an env episode.

Actions
-------
An action is the engine's native decision type: ``Dict[job_id, Alloc]``
(jobs absent from the map idle; ``None`` means "idle everyone").

Observations
------------
A dict of NumPy arrays (variable-length along the job axis):

- ``t``            — current simulation time (seconds);
- ``queue`` / ``queue_ids``     — per waiting job: ``[n_workers,
  remaining_iters, wait_seconds, tp_mean, tp_max]``;
- ``running`` / ``running_ids`` — per allocated job: ``[n_workers,
  remaining_iters, alloc_size, rate, tp_mean, tp_max]``;
- ``free`` / ``capacity``       — free and total device counts per
  (node, gpu_type) key, full-cluster key order (down nodes show 0
  free);
- ``price``        — Eq. 5 marginal price of the next device on each
  key at the current occupancy (``+inf`` on down nodes); disable with
  ``price_obs=False``;
- ``down``         — 0/1 mask over nodes currently failed.

Rewards
-------
``reward=`` selects from :data:`REWARDS` (or pass a callable taking a
:class:`StepWindow`):

- ``neg_jct`` — negative job-seconds in flight over the elapsed window
  (hours); the episode total telescopes to exactly ``-sum(JCT)/3600``;
- ``gru``     — time-weighted GPU utilization of the window;
- ``goodput`` — utilization net of fault losses (rollbacks + fault
  restart penalties), the ``SimResult.goodput()`` integrand.

``faults=`` and the ``REPRO_SANITIZE`` / ``sanitize=`` switch pass
straight through to the engine; same-seed episodes are
bitwise-reproducible, rewards included.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.types import (Alloc, Cluster, Job, alloc_size,
                                   clone_jobs)
from repro_torch.sim.engine import (RESTART_PENALTY, ConsultPoint,
                                    _apply_solver, event_stream)
from repro_torch.sim.metrics import EventSimResult


@dataclasses.dataclass
class StepWindow:
    """The slice of simulated time covered by one ``step()`` call,
    with the engine's cumulative GPU-second accounting at both ends —
    everything a reward needs, one subtraction away."""
    t0: float
    t1: float
    jobs: List[Job]
    completed: List[int]            # job ids that finished in the window
    busy: float                     # delta GPU-seconds busy
    avail: float                    # delta GPU-seconds available (live)
    lost: float                     # delta GPU-seconds lost to faults
    evictions: int                  # evictions in the window


def _reward_neg_jct(w: StepWindow) -> float:
    """-(job-seconds in flight over [t0, t1]) / 3600.  Exact: each job
    contributes its overlap with the window, so the episode sum
    telescopes to -sum_j (finish_j - arrival_j) / 3600 once every job
    has finished (arrivals and completions between consult points —
    e.g. during a total outage — are still integrated correctly)."""
    s = 0.0
    for j in w.jobs:
        end = j.finish_time if j.finish_time is not None else w.t1
        s += max(0.0, min(end, w.t1) - max(j.arrival, w.t0))
    return -s / 3600.0


def _reward_gru(w: StepWindow) -> float:
    """Time-weighted GPU utilization of the window (0 when no live
    capacity existed, e.g. a total outage)."""
    return w.busy / w.avail if w.avail > 0.0 else 0.0


def _reward_goodput(w: StepWindow) -> float:
    """Window utilization net of fault waste — the ``goodput()``
    integrand; equals the ``gru`` reward while nothing fails."""
    return max(0.0, w.busy - w.lost) / w.avail if w.avail > 0.0 else 0.0


REWARDS: Dict[str, Callable[[StepWindow], float]] = {
    "neg_jct": _reward_neg_jct,
    "gru": _reward_gru,
    "goodput": _reward_goodput,
}


class ClusterSchedulingEnv:
    """Duck-typed Gymnasium environment over the continuous-time engine
    (see module docstring).

    ``jobs`` is a template trace: it is cloned pristine at every
    ``reset()``, so episodes can never leak ``done_iters`` /
    ``evictions`` / ``lost_iters`` state into one another (or into the
    caller's list).  ``trace_factory(seed) -> List[Job]`` optionally
    regenerates the template when ``reset(seed=...)`` is called with a
    new seed.

    ``stable`` mirrors ``Scheduler.stable_when_idle`` for the wrapped
    policy: leave False for policies that rotate allocations (they are
    re-consulted on a ``round_len`` quantum while jobs are active);
    ``run_policy`` sets it from the scheduler automatically.
    """

    metadata = {"render_modes": ["ansi"]}

    def __init__(self, jobs: List[Job], cluster: Cluster,
                 round_len: float = 360.0,
                 reward: Union[str, Callable[[StepWindow], float]]
                 = "neg_jct",
                 faults=None,
                 sanitize: Optional[bool] = None,
                 max_events: int = 500000,
                 max_steps: Optional[int] = None,
                 restart_penalty: float = RESTART_PENALTY,
                 checkpoint_interval: Optional[float] = None,
                 stable: bool = False,
                 trace_factory: Optional[Callable[[int], List[Job]]]
                 = None,
                 price_obs: bool = True,
                 horizon: float = 7 * 24 * 3600.0,
                 name: str = "env"):
        self.cluster = cluster
        self.round_len = float(round_len)
        self.faults = faults
        self.sanitize = sanitize
        self.max_events = int(max_events)
        self.max_steps = max_steps
        self.restart_penalty = restart_penalty
        self.checkpoint_interval = checkpoint_interval
        self.stable = bool(stable)
        self.trace_factory = trace_factory
        self.price_obs = bool(price_obs)
        self.horizon = float(horizon)
        self.name = name
        if callable(reward):
            self.reward_fn = reward
        else:
            if reward not in REWARDS:
                raise ValueError(f"unknown reward {reward!r}; choose "
                                 f"from {sorted(REWARDS)} or pass a "
                                 "callable")
            self.reward_fn = REWARDS[reward]
        self._template = clone_jobs(jobs)
        # full-cluster key axis, PriceState order (node, then the
        # node's own gpus order) — observation shape is episode-stable
        # even while nodes are down
        self._keys: List[Tuple[int, str]] = [
            (n.node_id, r) for n in cluster.nodes for r in n.gpus]
        self._key_index = {k: i for i, k in enumerate(self._keys)}
        self._cap_arr = np.array(
            [float(n.gpus[r]) for n in cluster.nodes for r in n.gpus])
        self._node_of_key = np.array(
            [n.node_id for n in cluster.nodes for _ in n.gpus],
            dtype=np.intp)
        self._node_ids = [n.node_id for n in cluster.nodes]
        self._gen = None
        self._cp: Optional[ConsultPoint] = None
        self._jobs: List[Job] = []
        self.result: Optional[EventSimResult] = None
        self._seed = 0
        self._steps = 0
        self._done = True

    # ------------------------------------------------------------------
    # gym API
    # ------------------------------------------------------------------

    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._seed = int(seed)
            if self.trace_factory is not None:
                self._template = clone_jobs(self.trace_factory(self._seed))
        if self._gen is not None:
            self._gen.close()
        self._jobs = clone_jobs(self._template)
        self._gen = event_stream(
            self._jobs, self.cluster, round_len=self.round_len,
            max_events=self.max_events,
            restart_penalty=self.restart_penalty,
            sanitize=self.sanitize, faults=self.faults,
            checkpoint_interval=self.checkpoint_interval,
            stable=self.stable, name=self.name)
        self.result = None
        self._steps = 0
        self._done = False
        try:
            self._cp = self._gen.send(None)
        except StopIteration as stop:       # empty trace: instant episode
            self.result = stop.value
            self._cp = None
            self._done = True
            return self._terminal_obs(), self._terminal_info()
        return self._observe(self._cp), self._info(self._cp)

    def step(self, action: Optional[Dict[int, Alloc]]):
        if self._done or self._gen is None:
            raise RuntimeError("step() on a finished episode — call "
                               "reset() first")
        if action is not None and not isinstance(action, dict):
            raise TypeError("action must be a Dict[job_id, Alloc] or "
                            "None")
        cp_prev = self._cp
        t0 = cp_prev.t
        snap0 = (cp_prev.busy_gpu_seconds, cp_prev.avail_gpu_seconds,
                 cp_prev.lost_gpu_seconds, cp_prev.evictions)
        self._steps += 1
        try:
            cp = self._gen.send((action or {}, 0.0))
        except StopIteration as stop:
            self.result = stop.value
            self._cp = None
            self._done = True
            r = stop.value
            w = StepWindow(
                t0=t0, t1=r.total_seconds, jobs=self._jobs,
                completed=[j.job_id for j in self._jobs
                           if j.finish_time is not None
                           and j.finish_time > t0],
                busy=r.gpu_seconds_busy - snap0[0],
                avail=r.gpu_seconds_avail - snap0[1],
                lost=r.gpu_seconds_lost - snap0[2],
                evictions=r.evictions - snap0[3])
            return (self._terminal_obs(), self.reward_fn(w), True, False,
                    self._terminal_info())
        self._cp = cp
        w = StepWindow(
            t0=t0, t1=cp.t, jobs=self._jobs, completed=list(cp.completed),
            busy=cp.busy_gpu_seconds - snap0[0],
            avail=cp.avail_gpu_seconds - snap0[1],
            lost=cp.lost_gpu_seconds - snap0[2],
            evictions=cp.evictions - snap0[3])
        reward = self.reward_fn(w)
        truncated = (self.max_steps is not None
                     and self._steps >= self.max_steps)
        if truncated:
            self._gen.close()
            self._done = True
        return (self._observe(cp), reward, False, truncated,
                self._info(cp))

    def render(self) -> str:
        if self._cp is None:
            r = self.result
            return (f"[{self.name}] episode over: "
                    f"TTD {r.total_seconds:.0f}s" if r is not None
                    else f"[{self.name}] not started")
        cp = self._cp
        running = sum(1 for j in self._jobs if j.alloc and not j.is_done())
        return (f"[{self.name}] t={cp.t:.0f}s queue={cp.queue_len} "
                f"running={running} down={sorted(cp.down)}")

    def close(self) -> None:
        if self._gen is not None:
            self._gen.close()
            self._gen = None
        self._done = True

    # ------------------------------------------------------------------
    # observation building
    # ------------------------------------------------------------------

    def _job_rows(self, jobs, t, with_alloc):
        rows, ids = [], []
        for j in jobs:
            tps = [x for x in j.throughput.values() if x > 0.0]
            tp_mean = sum(tps) / len(tps) if tps else 0.0
            tp_max = max(tps) if tps else 0.0
            if with_alloc:
                rows.append([float(j.n_workers), j.remaining_iters,
                             float(alloc_size(j.alloc)),
                             j.bottleneck_rate(j.alloc), tp_mean, tp_max])
            else:
                rows.append([float(j.n_workers), j.remaining_iters,
                             t - j.arrival, tp_mean, tp_max])
            ids.append(j.job_id)
        width = 6 if with_alloc else 5
        return (np.array(rows, dtype=float).reshape(len(rows), width),
                np.array(ids, dtype=np.int64))

    def _free_arr(self, down: frozenset) -> np.ndarray:
        free = self._cap_arr.copy()
        for j in self._jobs:
            if j.alloc and not j.is_done():
                for k, c in j.alloc.items():
                    m = self._key_index.get(k)
                    if m is not None:
                        free[m] -= c
        if down:
            free[np.isin(self._node_of_key, sorted(down))] = 0.0
        return free

    def _prices(self, t: float, down: frozenset) -> np.ndarray:
        from repro_torch.core.pricing import PriceState
        from repro_torch.core.utility import effective_throughput
        active = [j for j in self._jobs
                  if not j.is_done() and j.arrival <= t]
        # host pricing only: no device view is taken, so no card is needed
        ps = PriceState(self.cluster, active, self.horizon,
                        effective_throughput, now=t, device="cpu")
        used = np.zeros(len(self._keys))
        for j in self._jobs:
            if j.alloc and not j.is_done():
                for k, c in j.alloc.items():
                    m = self._key_index.get(k)
                    if m is not None:
                        used[m] += c
        # env key order == PriceState key order (both walk nodes, then
        # each node's own gpus order)
        price = ps.unit_prices(used, 1)[:, 0]
        if down:
            price[np.isin(self._node_of_key, sorted(down))] = np.inf
        return price

    def _observe(self, cp: ConsultPoint) -> Dict[str, np.ndarray]:
        t = cp.t
        waiting = [j for j in self._jobs if not j.is_done()
                   and j.arrival <= t and j.alloc is None]
        running = [j for j in self._jobs if not j.is_done()
                   and j.alloc is not None]
        q_rows, q_ids = self._job_rows(waiting, t, with_alloc=False)
        r_rows, r_ids = self._job_rows(running, t, with_alloc=True)
        obs = {
            "t": np.float64(t),
            "queue": q_rows, "queue_ids": q_ids,
            "running": r_rows, "running_ids": r_ids,
            "free": self._free_arr(cp.down),
            "capacity": self._cap_arr.copy(),
            "down": np.array([1.0 if h in cp.down else 0.0
                              for h in self._node_ids]),
        }
        if self.price_obs:
            obs["price"] = self._prices(t, cp.down)
        return obs

    def _terminal_obs(self) -> Dict[str, np.ndarray]:
        t = self.result.total_seconds if self.result is not None else 0.0
        empty_q = np.zeros((0, 5))
        empty_r = np.zeros((0, 6))
        obs = {
            "t": np.float64(t),
            "queue": empty_q, "queue_ids": np.zeros(0, dtype=np.int64),
            "running": empty_r,
            "running_ids": np.zeros(0, dtype=np.int64),
            "free": self._cap_arr.copy(),
            "capacity": self._cap_arr.copy(),
            "down": np.zeros(len(self._node_ids)),
        }
        if self.price_obs:
            obs["price"] = np.zeros(len(self._keys))
        return obs

    # ------------------------------------------------------------------
    # info
    # ------------------------------------------------------------------

    def _info(self, cp: ConsultPoint) -> dict:
        return {"t": cp.t, "consult": cp, "completed": list(cp.completed),
                "queue_len": cp.queue_len, "down": set(cp.down),
                "evictions": cp.evictions,
                "busy_gpu_seconds": cp.busy_gpu_seconds,
                "avail_gpu_seconds": cp.avail_gpu_seconds,
                "lost_gpu_seconds": cp.lost_gpu_seconds,
                "result": None}

    def _terminal_info(self) -> dict:
        r = self.result
        return {"t": r.total_seconds if r is not None else 0.0,
                "consult": None, "completed": [], "queue_len": 0,
                "down": set(), "evictions": r.evictions if r else 0,
                "busy_gpu_seconds": r.gpu_seconds_busy if r else 0.0,
                "avail_gpu_seconds": r.gpu_seconds_avail if r else 0.0,
                "lost_gpu_seconds": r.gpu_seconds_lost if r else 0.0,
                "result": r}


def run_policy(env: ClusterSchedulingEnv, scheduler,
               solver: Optional[str] = None,
               seed: Optional[int] = None):
    """Drive a native ``Scheduler`` through one env episode.

    Sets ``env.stable`` from the scheduler (consult cadence), forwards
    completion notifications before each decision, and labels the
    result with the scheduler's name — so the returned
    ``EventSimResult`` is bitwise what ``simulate_events(scheduler,
    ...)`` produces on the same trace.

    Returns ``(result, rewards)`` where ``rewards`` is the per-step
    reward trajectory.
    """
    _apply_solver(scheduler, solver)
    env.stable = bool(getattr(scheduler, "stable_when_idle", False))
    env.name = scheduler.name
    obs, info = env.reset(seed=seed)
    rewards: List[float] = []
    while info["consult"] is not None:
        cp: ConsultPoint = info["consult"]
        if cp.completed and hasattr(scheduler, "note_completion"):
            scheduler.note_completion()
        action = scheduler.schedule(cp.t, cp.round_len, cp.jobs, cp.view)
        obs, reward, terminated, truncated, info = env.step(action)
        rewards.append(reward)
        if terminated or truncated:
            break
    return env.result, rewards

"""Opt-in observability for the scheduling stack (trace + metrics +
allocation provenance), zero-overhead when disabled.

The port's copy of ``repro.obs``.  Same null-object pattern as the
``REPRO_SANITIZE`` runtime sanitizer: every hook site resolves the
installed observer once (``obs.get()``) and guards its richer calls on
the ``enabled`` class attribute, so the disabled path costs one attribute
test — no kwargs dicts are built, no strings formatted, no device result
copied to the host.  The only always-on piece is :class:`StopWatch`, the
single wall-clock timer the engines' ``sched_seconds`` fields share.

Activation (the JAX package's variable names, so one setting switches on
both packages' observers):

- environment — ``REPRO_OBS=1`` installs a process-wide observer at
  import; ``REPRO_OBS_TRACE`` / ``REPRO_OBS_DECISIONS`` /
  ``REPRO_OBS_METRICS`` name output files written at interpreter exit
  (Perfetto JSON, decision JSONL, metrics-summary JSON).
- programmatic — ``with obs.session(trace_path=...) as ob: ...`` scopes
  an observer to a block and writes its outputs on exit.

What gets recorded: scheduler-consult latency spans + histogram, solver
dispatches (backend, bucket, queue length), PriceState
commit/release/refresh, event-queue pops, per-interval sim-time spans,
HadarE consolidation points, faults and evictions, free capacity per
(node, GPU-type), and the per-decision provenance log
(``repro_torch.obs.explain``) with K4's and K5's runner-ups.  Where the
JAX package counts XLA work the port counts its kernels:
``kernel_shapes`` (distinct K4/K5 dispatch-shape keys a session sees; the
reference's ``jax_recompiles``) and ``kernel_builds`` (libraries
``kernels/build.py`` builds or loads in the process; the reference's
``jax_kernel_builds``).  Every other name is the reference's.

Decisions are **bit-identical** with observability on or off — hooks
only read scheduler state.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import time
from typing import Optional, Set, Tuple

from .explain import (DecisionLog, decision_record, eviction_record,
                      explain_allocation)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import SIM_PID, WALL_PID, TraceRecorder, validate_trace

ENV_FLAG = "REPRO_OBS"
ENV_TRACE = "REPRO_OBS_TRACE"
ENV_DECISIONS = "REPRO_OBS_DECISIONS"
ENV_METRICS = "REPRO_OBS_METRICS"

_TRUTHY = {"1", "true", "yes", "on"}


class StopWatch:
    """The one wall-clock timer: ``with StopWatch() as sw: ...`` or
    explicit ``start()``/``stop()``.  ``seconds`` holds the last lap."""

    __slots__ = ("seconds", "_t0")

    def __init__(self):
        self.seconds = 0.0
        self._t0 = 0.0

    def start(self) -> "StopWatch":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        self.seconds = time.perf_counter() - self._t0
        return self.seconds

    __enter__ = start

    def __exit__(self, *exc) -> None:
        self.stop()


class _ConsultTimer(StopWatch):
    """StopWatch that also feeds the decision-latency histogram and
    emits a wall-track consult span when it stops."""

    __slots__ = ("_ob", "_engine", "_sched", "_t", "_qlen", "_us0")

    def __init__(self, ob: "Observer", engine: str, sched: str, t: float,
                 qlen: int):
        super().__init__()
        self._ob = ob
        self._engine = engine
        self._sched = sched
        self._t = t
        self._qlen = qlen
        self._us0 = 0.0

    def start(self) -> "_ConsultTimer":
        if self._ob.trace is not None:
            self._us0 = self._ob.trace.now()
        return super().start()

    __enter__ = start

    def __exit__(self, *exc) -> None:
        self.stop()
        ob = self._ob
        if ob.metrics is not None:
            ob.metrics.counter("consults").inc()
            ob.metrics.histogram("decision_latency_s").observe(
                self.seconds)
        if ob.trace is not None:
            ob.trace.complete("consult", self._us0, {
                "engine": self._engine, "scheduler": self._sched,
                "t": self._t, "queue_len": self._qlen})
            ob.trace.sim_instant("consult", self._t, {
                "engine": self._engine, "wall_ms": self.seconds * 1e3})


class NullObserver:
    """Disabled observability: every hook is a no-op.  Hook sites guard
    anything that would build arguments on ``enabled``, so this class
    only needs the methods called unconditionally."""

    enabled = False
    __slots__ = ()
    trace = None
    metrics = None
    decisions = None

    def consult(self, engine: str, scheduler: str, t: float,
                queue_len: int = 0) -> StopWatch:
        return StopWatch()

    def close(self) -> None:
        pass


class Observer:
    """Active observability session: a trace recorder, a metrics
    registry, and a decision log (each individually optional)."""

    enabled = True

    def __init__(self, trace: bool = True, metrics: bool = True,
                 decisions: bool = True,
                 trace_path: Optional[str] = None,
                 decisions_path: Optional[str] = None,
                 metrics_path: Optional[str] = None):
        self.trace = TraceRecorder() if (trace or trace_path) else None
        self.metrics = MetricsRegistry() if (metrics or metrics_path) \
            else None
        self.decisions = DecisionLog() if (decisions or decisions_path) \
            else None
        self.trace_path = trace_path
        self.decisions_path = decisions_path
        self.metrics_path = metrics_path
        self._kernel_shapes: Set[Tuple] = set()
        self._closed = False

    # ---- hot-path hooks -------------------------------------------------
    def consult(self, engine: str, scheduler: str, t: float,
                queue_len: int = 0) -> _ConsultTimer:
        return _ConsultTimer(self, engine, scheduler, t, queue_len)

    def begin(self) -> float:
        """Open a wall span; pair with :meth:`end`."""
        return self.trace.now() if self.trace is not None else 0.0

    def end(self, name: str, start_us: float, **args) -> None:
        if self.trace is not None:
            self.trace.complete(name, start_us, args)

    def instant(self, name: str, **args) -> None:
        if self.trace is not None:
            self.trace.instant(name, args)

    def sim_span(self, name: str, t0: float, t1: float, **args) -> None:
        if self.trace is not None:
            self.trace.sim_span(name, t0, t1, args)

    def sim_instant(self, name: str, t: float, **args) -> None:
        if self.trace is not None:
            self.trace.sim_instant(name, t, args)

    def count(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc(n)

    def gauge(self, name: str, v: float) -> None:
        if self.metrics is not None:
            self.metrics.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        if self.metrics is not None:
            self.metrics.histogram(name).observe(v)

    def interval(self, engine: str, t0: float, dt: float, gru: float,
                 cru: float, running: int, waiting: int,
                 changed: int) -> None:
        """One closed engine interval/round [t0, t0 + dt): sim-track
        span + queue depth and utilization series.  The span's ts/dur
        are exactly ``t0``/``dt`` scaled to trace microseconds, so they
        match the engine's IntervalRecord boundaries bitwise."""
        if self.trace is not None:
            self.trace.sim_span("interval", t0, t0 + dt, {
                "engine": engine, "gru": gru, "cru": cru,
                "running": running, "waiting": waiting,
                "changed": changed}, dur=dt)
        if self.metrics is not None:
            self.metrics.gauge("queue_depth").set(waiting)
            self.metrics.histogram("queue_depth").observe(waiting)
            self.metrics.histogram("gru").observe(gru)
            self.metrics.histogram("cru").observe(cru)

    def completion(self, t: float, job_id: int, jct: float) -> None:
        if self.metrics is not None:
            self.metrics.counter("jobs_completed").inc()
            self.metrics.histogram("jct_seconds").observe(jct)
        if self.trace is not None:
            self.trace.sim_instant("completion", t,
                                   {"job": job_id, "jct_s": jct})

    def fault(self, kind: str, t: float, node_id: int,
              t_recover: Optional[float] = None) -> None:
        """A node failure / spot preemption / recovery: per-kind
        ``faults.*`` counter plus a sim-track outage span (when the
        recovery time is known up front; on the node's own lane, since an
        outage may end inside a round) or instant."""
        if self.metrics is not None:
            self.metrics.counter(f"faults.{kind}").inc()
        if self.trace is not None:
            if (t_recover is not None and t_recover > t
                    and t_recover != float("inf")):
                self.trace.sim_span(f"fault.{kind}", t, t_recover,
                                    {"node": node_id},
                                    lane=f"node {node_id}")
            else:
                self.trace.sim_instant(f"fault.{kind}", t,
                                       {"node": node_id})

    def eviction(self, rec: dict) -> None:
        """Fault-eviction provenance: counters + decision-log record
        (``phase="eviction"``, see ``explain.eviction_record``)."""
        if self.metrics is not None:
            self.metrics.counter("faults.evictions").inc()
            self.metrics.histogram("faults.lost_gpu_seconds").observe(
                float(rec.get("lost_gpu_seconds", 0.0)))
        if self.decisions is not None:
            self.decisions.record(rec)

    def price_op(self, op: str, n_keys: int) -> None:
        """PriceState commit/release accounting."""
        if self.metrics is not None:
            self.metrics.counter(f"pricestate_{op}s").inc()
        if self.trace is not None:
            self.trace.instant(f"pricestate.{op}", {"keys": n_keys})

    def free_capacity(self, keys, free_arr) -> None:
        """Per-(node, GPU-type) free-device gauges from a PriceState."""
        if self.metrics is not None:
            for (node, gtype), f in zip(keys, free_arr):
                self.metrics.gauge(f"free_gpus.{node}.{gtype}").set(
                    float(f))

    def kernel_shape(self, key: Tuple) -> None:
        """Batched-solver dispatch shape (K4's or K5's launch geometry):
        counted once per distinct key a session sees (the bucket sizes
        bound these)."""
        if key not in self._kernel_shapes:
            self._kernel_shapes.add(key)
            if self.metrics is not None:
                self.metrics.counter("kernel_shapes").inc()

    def decision(self, rec: dict) -> None:
        if self.decisions is not None:
            self.decisions.record(rec)
        if self.metrics is not None:
            self.metrics.counter("decisions").inc()

    # ---- lifecycle ------------------------------------------------------
    def close(self) -> None:
        """Write any configured output files (idempotent)."""
        if self._closed:
            return
        self._closed = True
        if self.trace_path and self.trace is not None:
            self.trace.save(self.trace_path)
        if self.decisions_path and self.decisions is not None:
            self.decisions.save_jsonl(self.decisions_path)
        if self.metrics_path and self.metrics is not None:
            with open(self.metrics_path, "w", encoding="utf-8") as fh:
                json.dump(self.metrics.summary(), fh, indent=1)


NULL = NullObserver()
_current = NULL


def get():
    """The installed observer (hot-path hook resolution point)."""
    return _current


def enabled() -> bool:
    return _current.enabled


def install(ob) -> object:
    """Install ``ob`` as the process observer; returns the previous one."""
    global _current
    prev = _current
    _current = ob
    return prev


@contextlib.contextmanager
def session(trace: bool = True, metrics: bool = True,
            decisions: bool = True, trace_path: Optional[str] = None,
            decisions_path: Optional[str] = None,
            metrics_path: Optional[str] = None):
    """Scope an :class:`Observer` to a block::

        with obs.session(trace_path="out.json") as ob:
            simulate_events(...)
        print(ob.metrics.summary())

    The previous observer is restored and output files are written when
    the block exits.
    """
    ob = Observer(trace=trace, metrics=metrics, decisions=decisions,
                  trace_path=trace_path, decisions_path=decisions_path,
                  metrics_path=metrics_path)
    prev = install(ob)
    try:
        yield ob
    finally:
        install(prev)
        ob.close()


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in _TRUTHY


def _install_from_env() -> None:
    if not (_env_truthy(ENV_FLAG) or os.environ.get(ENV_TRACE)
            or os.environ.get(ENV_DECISIONS)
            or os.environ.get(ENV_METRICS)):
        return
    ob = Observer(trace_path=os.environ.get(ENV_TRACE) or None,
                  decisions_path=os.environ.get(ENV_DECISIONS) or None,
                  metrics_path=os.environ.get(ENV_METRICS) or None)
    install(ob)
    atexit.register(ob.close)


_install_from_env()

__all__ = [
    "Counter", "DecisionLog", "Gauge", "Histogram", "MetricsRegistry",
    "NullObserver", "Observer", "StopWatch", "TraceRecorder",
    "decision_record", "enabled", "eviction_record", "explain_allocation",
    "get", "install",
    "session", "validate_trace",
]

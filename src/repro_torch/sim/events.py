"""Heap-based event queue for the continuous-time simulator.

The port's copy of ``repro.sim.events``, without the sanitizer's
pop-order check.

Six event kinds drive the engine:

- ``ARRIVAL``      — a job's submit time was reached; it joins the queue.
- ``COMPLETION``   — a *predicted* completion.  Predictions are made when
  an allocation is (re)assigned: ``t_fin = max(t, penalty_end) +
  remaining / (rate * workers)``.  They stay exact as long as the
  allocation is untouched; when the scheduler changes a job's
  allocation the old prediction is invalidated lazily via a per-job
  version counter (no O(n) heap surgery).
- ``NODE_RECOVER`` — a failed/reclaimed node comes back; its capacity
  rejoins the schedulable pool.
- ``NODE_FAIL``    — a node fails (hardware MTBF); every job holding
  devices on it is evicted and rolled back to its last checkpoint.
- ``SPOT_PREEMPT`` — spot capacity is reclaimed; same eviction
  semantics as ``NODE_FAIL`` but accounted separately.
- ``RESCHEDULE``   — a periodic scheduling quantum.  Only needed for
  schedulers without ``stable_when_idle`` (Gavel/Tiresias rotate
  allocations every round even with no arrivals/completions).

Ties at the same timestamp are ordered ARRIVAL < COMPLETION <
NODE_RECOVER < NODE_FAIL < SPOT_PREEMPT < RESCHEDULE, then FIFO by push
order:

- an arrival coinciding with anything else is active when the scheduler
  runs (unchanged from the three-kind ordering);
- a completion predicted for exactly the failure instant *completes* —
  the job had finished when the node died, so it is not rolled back;
- capacity recovering at t is schedulable at t even if another node
  fails in the same instant (recover before fail also makes
  back-to-back windows on one node — recover at t, next failure at t —
  well-defined: the node is up for a zero-length instant, not down
  twice);
- all fault kinds precede the reschedule quantum, so a coinciding
  consult prices against the post-fault capacity.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
from typing import Dict, List, Optional


class EventKind(enum.IntEnum):
    ARRIVAL = 0
    COMPLETION = 1
    NODE_RECOVER = 2
    NODE_FAIL = 3
    SPOT_PREEMPT = 4
    RESCHEDULE = 5


#: event kinds that carry a node payload instead of a job payload
FAULT_KINDS = frozenset({EventKind.NODE_RECOVER, EventKind.NODE_FAIL,
                         EventKind.SPOT_PREEMPT})


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    kind: EventKind
    job_id: Optional[int] = None
    node_id: Optional[int] = None


class EventQueue:
    """Min-heap of (time, kind, seq) with lazy completion invalidation."""

    def __init__(self):
        self._heap: List[tuple] = []
        self._seq = itertools.count()
        self._version: Dict[int, int] = {}      # job_id -> live version
        self._resched_at: Optional[float] = None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push_arrival(self, time: float, job_id: int) -> None:
        heapq.heappush(self._heap, (time, int(EventKind.ARRIVAL),
                                    next(self._seq), job_id, 0))

    def push_completion(self, time: float, job_id: int) -> None:
        """Predict a completion; superseded by invalidate_completion."""
        v = self._version.get(job_id, 0)
        heapq.heappush(self._heap, (time, int(EventKind.COMPLETION),
                                    next(self._seq), job_id, v))

    def invalidate_completion(self, job_id: int) -> None:
        """Drop any outstanding completion prediction for ``job_id``."""
        self._version[job_id] = self._version.get(job_id, 0) + 1

    def push_fault(self, time: float, kind: EventKind,
                   node_id: int) -> None:
        """Schedule a NODE_FAIL / NODE_RECOVER / SPOT_PREEMPT for a node.
        Fault events are never invalidated — a failure schedule is an
        exogenous input, not a prediction."""
        if kind not in FAULT_KINDS:
            raise ValueError(f"push_fault with non-fault kind {kind!r}")
        heapq.heappush(self._heap, (time, int(kind),
                                    next(self._seq), node_id, 0))

    def push_reschedule(self, time: float) -> None:
        """At most one pending reschedule; keep the earliest.  Only the
        event whose time equals the pending mark is live — superseded or
        already-consumed quanta are discarded lazily."""
        if self._resched_at is not None and self._resched_at <= time:
            return
        self._resched_at = time
        heapq.heappush(self._heap, (time, int(EventKind.RESCHEDULE),
                                    next(self._seq), None, 0))

    def _discard_stale(self) -> None:
        while self._heap:
            time, kind, _, job_id, v = self._heap[0]
            if (kind == int(EventKind.COMPLETION)
                    and v != self._version.get(job_id, 0)):
                heapq.heappop(self._heap)
                continue
            if (kind == int(EventKind.RESCHEDULE)
                    and time != self._resched_at):
                heapq.heappop(self._heap)       # superseded or consumed
                continue
            return

    def peek_time(self) -> Optional[float]:
        self._discard_stale()
        return self._heap[0][0] if self._heap else None

    def pop_batch(self) -> List[Event]:
        """Pop every live event sharing the earliest timestamp."""
        self._discard_stale()
        if not self._heap:
            return []
        t0 = self._heap[0][0]
        out: List[Event] = []
        while self._heap and self._heap[0][0] == t0:
            time, kind, _, payload, v = heapq.heappop(self._heap)
            if (kind == int(EventKind.COMPLETION)
                    and v != self._version.get(payload, 0)):
                continue
            if kind == int(EventKind.RESCHEDULE):
                if time != self._resched_at:
                    continue                    # superseded or consumed
                self._resched_at = None
            if EventKind(kind) in FAULT_KINDS:
                out.append(Event(time, EventKind(kind), node_id=payload))
            else:
                out.append(Event(time, EventKind(kind), job_id=payload))
            self._discard_stale()
        return out

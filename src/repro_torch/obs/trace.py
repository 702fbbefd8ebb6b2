"""Chrome-trace-event / Perfetto-compatible span recorder.

The port's copy of ``repro.obs.trace``, with one change: a sim-track
span may name a *lane*, which puts it on a thread of its own within its
run.  The engines give each node's outage span (``fault.*``) the node's
lane.  The JAX package puts those spans on the run's own thread, where an
outage that ends inside a round partially overlaps that round's
``interval`` span, so a trace of a faulted round run fails
:func:`validate_trace`; every event keeps the reference's name, ``ts``,
``dur`` and args.

Events are emitted in the Trace Event JSON format (the ``traceEvents``
array understood by ``ui.perfetto.dev`` and ``chrome://tracing``) on two
*tracks*, modeled as two pids:

- **wall** (pid 1) — real elapsed time: scheduler consults, solver
  dispatches, PriceState refreshes.  Timestamps are microseconds since
  the recorder was constructed (``perf_counter`` based).
- **sim**  (pid 2) — simulated time: engine intervals/rounds, HadarE
  consolidation points, completion instants.  Timestamps are the
  engine's own ``t`` (seconds) scaled to microseconds, so a span's
  extent in Perfetto *is* its extent in simulated time.

All spans are complete events (``ph == "X"``); instants are ``"i"``.
Nothing here imports the scheduling core — the recorder is a plain
append-only event list with a JSON serializer.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

WALL_PID = 1
SIM_PID = 2
# sim-track lane threads are numbered from here, above any run's tid
LANE_TID0 = 1000001

_TRACK_NAMES = {WALL_PID: "wall-clock", SIM_PID: "sim-time"}


class TraceRecorder:
    """Append-only two-track trace event recorder."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self.events: List[dict] = []
        # One sim-track tid per simulation *epoch*: a process-wide
        # observer can span several runs, each restarting simulated
        # time at 0 — their spans must not share a track or they would
        # partially overlap.  Span starts are non-decreasing within a
        # run, so a backwards start means a new run.
        self._sim_tid = 1
        self._last_sim_ts: Optional[float] = None
        # (run tid, lane name) -> the lane's thread
        self._lanes: Dict[tuple, int] = {}

    # ---- wall track -----------------------------------------------------
    def now(self) -> float:
        """Current wall timestamp in trace microseconds."""
        return (time.perf_counter() - self._t0) * 1e6

    def complete(self, name: str, start_us: float,
                 args: Optional[dict] = None) -> None:
        """Close a wall span opened at ``start_us`` (from :meth:`now`)."""
        self.events.append({
            "name": name, "ph": "X", "pid": WALL_PID, "tid": 1,
            "ts": start_us, "dur": max(self.now() - start_us, 0.0),
            "args": args or {}})

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        self.events.append({
            "name": name, "ph": "i", "s": "t", "pid": WALL_PID, "tid": 1,
            "ts": self.now(), "args": args or {}})

    # ---- sim track ------------------------------------------------------
    def sim_span(self, name: str, t0: float, t1: float,
                 args: Optional[dict] = None,
                 dur: Optional[float] = None,
                 lane: Optional[str] = None) -> None:
        """Span [t0, t1) in simulated seconds.  ``dur`` overrides the
        ``t1 - t0`` subtraction when the caller holds the exact interval
        length (float subtraction would reintroduce rounding).  ``lane``
        puts the span on that lane's thread of the current run, for spans
        that may end inside another span of the run."""
        d = (t1 - t0) if dur is None else dur
        ts = t0 * 1e6
        if self._last_sim_ts is not None and ts < self._last_sim_ts:
            self._sim_tid += 1
        self._last_sim_ts = ts
        tid = self._sim_tid
        if lane is not None:
            tid = self._lanes.setdefault((tid, lane),
                                         LANE_TID0 + len(self._lanes))
        self.events.append({
            "name": name, "ph": "X", "pid": SIM_PID,
            "tid": tid, "ts": ts, "dur": max(d, 0.0) * 1e6,
            "args": args or {}})

    def sim_instant(self, name: str, t: float,
                    args: Optional[dict] = None) -> None:
        # instants inherit the current epoch but never advance it:
        # completion instants legitimately run ahead of the next span
        self.events.append({
            "name": name, "ph": "i", "s": "t", "pid": SIM_PID,
            "tid": self._sim_tid, "ts": t * 1e6, "args": args or {}})

    # ---- serialization --------------------------------------------------
    def to_json(self) -> dict:
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 1,
                 "args": {"name": label}}
                for pid, label in sorted(_TRACK_NAMES.items())]
        if self._sim_tid > 1:
            meta += [{"name": "thread_name", "ph": "M", "pid": SIM_PID,
                      "tid": k, "args": {"name": f"run {k}"}}
                     for k in range(1, self._sim_tid + 1)]
        meta += [{"name": "thread_name", "ph": "M", "pid": SIM_PID,
                  "tid": tid, "args": {"name": f"run {run} {lane}"}}
                 for (run, lane), tid in self._lanes.items()]
        return {"traceEvents": meta + list(self.events),
                "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_json(), fh)


# --------------------------------------------------------------------------
# schema validation / summarization (shared by tests, the CLI, and the
# check_speedup --quick smoke)
# --------------------------------------------------------------------------

def validate_trace(doc: dict) -> List[str]:
    """Structural schema check of a trace document.

    Returns a list of problems (empty == valid): the ``traceEvents``
    array exists, every event carries name/ph/pid/ts, complete events
    have a non-negative ``dur``, and same-track ``X`` spans strictly
    nest (no partial overlap) — the property Perfetto's track builder
    relies on to stack them.
    """
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    spans_by_track: Dict[tuple, List[tuple]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for field in ("name", "ph", "pid", "ts"):
            if field not in ev:
                if not (ev.get("ph") == "M" and field == "ts"):
                    problems.append(f"event {i}: missing {field!r}")
        if ev.get("ph") == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X event with bad dur {dur!r}")
            else:
                spans_by_track.setdefault(
                    (ev.get("pid"), ev.get("tid", 1)), []).append(
                    (float(ev["ts"]), float(ev["ts"]) + float(dur),
                     ev.get("name", "?")))
    for track, spans in spans_by_track.items():
        # parents before children: start ascending, longer span first
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[tuple] = []
        for s0, s1, name in spans:
            # relative tolerance: adjacent tiling spans carry ts = t*1e6
            # and dur = dt*1e6, so boundaries agree only to one float ulp
            # of the (large) microsecond timestamps
            tol = 1e-9 * max(1.0, abs(stack[-1][1])) if stack else 0.0
            while stack and s0 >= stack[-1][1] - tol:
                stack.pop()
                tol = (1e-9 * max(1.0, abs(stack[-1][1]))
                       if stack else 0.0)
            if stack and s1 > stack[-1][1] + tol:
                problems.append(
                    f"track {track}: span {name!r} [{s0}, {s1}) partially "
                    f"overlaps {stack[-1][2]!r} [{stack[-1][0]}, "
                    f"{stack[-1][1]})")
            stack.append((s0, s1, name))
    return problems


def summarize_trace(doc: dict) -> dict:
    """Per-(track, name) span statistics of a loaded trace document."""
    out: Dict[str, dict] = {}
    for ev in doc.get("traceEvents", []):
        if not isinstance(ev, dict) or ev.get("ph") not in ("X", "i"):
            continue
        track = _TRACK_NAMES.get(ev.get("pid"), str(ev.get("pid")))
        key = f"{track}/{ev.get('name', '?')}"
        row = out.setdefault(key, {"count": 0, "total_ms": 0.0})
        row["count"] += 1
        if ev.get("ph") == "X":
            row["total_ms"] += float(ev.get("dur", 0.0)) / 1e3
    return dict(sorted(out.items()))


def merge_traces(docs: List[dict]) -> dict:
    """Concatenate the event arrays of several trace documents (process
    metadata is deduplicated; tracks keep their pids)."""
    events: List[dict] = []
    seen_meta = set()
    for doc in docs:
        for ev in doc.get("traceEvents", []):
            if isinstance(ev, dict) and ev.get("ph") == "M":
                key = (ev.get("pid"), ev.get("name"),
                       json.dumps(ev.get("args", {}), sort_keys=True))
                if key in seen_meta:
                    continue
                seen_meta.add(key)
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}

"""Allocation provenance: *why* a job won its (node, GPU-type) keys.

The port's copy of ``repro.obs.explain``, unchanged.

Every committed scheduling decision is appended to a
:class:`DecisionLog` as one plain dict (JSONL on disk) carrying the
fields the paper's dual argument turns on:

- the winning allocation, key by key, with the **marginal unit price**
  (Eq. 5, at the gamma the key held when the decision committed) plus
  the ``gamma``/``cap``/``u_min``/``u_max`` inputs that price was
  computed from — so a log line is exactly re-derivable against
  ``PriceState.price`` (the integration tests pin this bitwise);
- the job's utility, price-cost, and payoff mu_j (the admission margin
  of Algorithm 2, lines 28-32);
- the **runner-up candidate** — the allocation shape that came second
  in FIND_ALLOC's enumeration — and the payoff gap it lost by;
- the scheduling phase (``dp`` = primal-dual selection, ``backfill`` =
  work-conserving backfill, where the mu_j gate is waived).

``explain_allocation`` renders one record as human-readable text;
``load_jsonl`` reads a log back for analysis.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional


class DecisionLog:
    """Append-only decision list with a JSONL serializer."""

    def __init__(self):
        self.decisions: List[dict] = []

    def record(self, rec: dict) -> None:
        self.decisions.append(rec)

    def __len__(self) -> int:
        return len(self.decisions)

    def save_jsonl(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            for rec in self.decisions:
                fh.write(json.dumps(rec) + "\n")


def load_jsonl(path: str) -> List[dict]:
    out: List[dict] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def decision_record(t: float, job_id: int, n_workers: int, phase: str,
                    solver: Optional[str], alloc_rows: List[dict],
                    cost: float, payoff: float, rate: float,
                    runner_up: Optional[dict]) -> dict:
    """Assemble one decision record (the single place the schema lives)."""
    return {
        "t": float(t),
        "job": int(job_id),
        "workers": int(n_workers),
        "phase": phase,
        "solver": solver,
        "alloc": alloc_rows,
        "cost": float(cost),
        "payoff": float(payoff),
        "utility": float(payoff) + float(cost),
        "rate": float(rate),
        "runner_up": runner_up,
    }


def eviction_record(t: float, job_id: int, n_workers: int, reason: str,
                    nodes: List[int], lost_iters: float,
                    lost_gpu_seconds: float, payoff: float,
                    order: int) -> dict:
    """Assemble one fault-eviction record (``phase="eviction"``).

    ``reason`` is ``node_fail`` / ``spot_preempt`` / ``capacity``;
    ``order`` is the victim's rank in the reverse-payoff eviction
    sequence (0 = lowest marginal utility, evicted first)."""
    return {
        "t": float(t),
        "job": int(job_id),
        "workers": int(n_workers),
        "phase": "eviction",
        "reason": reason,
        "nodes": [int(n) for n in nodes],
        "lost_iters": float(lost_iters),
        "lost_gpu_seconds": float(lost_gpu_seconds),
        "payoff": float(payoff),
        "order": int(order),
    }


def _fmt_runner_up(ru: Optional[dict], payoff: float) -> str:
    if not ru:
        return "runner-up: none (no other feasible candidate)"
    gap = payoff - float(ru.get("payoff", 0.0))
    if ru.get("kind") == "pack":
        what = f"consolidate on node {ru.get('node')}"
    else:
        what = (f"spread across {ru.get('n_servers', '?')} servers "
                f"(type-prefix {ru.get('prefix')})")
    return (f"runner-up: {what} — payoff {ru.get('payoff', 0.0):.6g}, "
            f"lost by {gap:.6g}")


def explain_allocation(rec: dict) -> str:
    """Render one decision record as human-readable provenance text."""
    if rec.get("phase") == "eviction":
        return (
            f"t={rec['t']:.1f}s job {rec['job']} "
            f"({rec['workers']} workers) EVICTED: {rec.get('reason')}\n"
            f"  nodes {rec.get('nodes')}, reverse-payoff rank "
            f"{rec.get('order')} (payoff proxy {rec.get('payoff', 0.0):.6g})\n"
            f"  rolled back {rec.get('lost_iters', 0.0):.6g} iters "
            f"({rec.get('lost_gpu_seconds', 0.0):.6g} GPU-seconds lost)")
    lines = [
        f"t={rec['t']:.1f}s job {rec['job']} "
        f"({rec['workers']} workers, phase={rec['phase']}"
        + (f", solver={rec['solver']}" if rec.get("solver") else "")
        + ")",
        f"  utility {rec['utility']:.6g} - cost {rec['cost']:.6g} "
        f"= payoff {rec['payoff']:.6g}"
        + ("  [mu_j gate waived: work-conserving backfill]"
           if rec["phase"] == "backfill" and rec["payoff"] <= 0 else ""),
        f"  bottleneck rate {rec['rate']:.6g} iters/s per worker",
    ]
    for row in rec.get("alloc", []):
        lines.append(
            f"  won {row['count']}x {row['type']} on node {row['node']} "
            f"@ marginal unit price {row['unit_price']:.6g} "
            f"(Eq.5: gamma {row['gamma']}/{row['cap']}, "
            f"U in [{row['u_min']:.3g}, {row['u_max']:.3g}])")
    lines.append("  " + _fmt_runner_up(rec.get("runner_up"),
                                       rec["payoff"]))
    return "\n".join(lines)


def summarize_decisions(records: List[dict]) -> dict:
    """Aggregate statistics over a decision log (CLI ``summarize``)."""
    phases: Dict[str, int] = {}
    jobs = set()
    keys: Dict[str, int] = {}
    for rec in records:
        phases[rec.get("phase", "?")] = phases.get(rec.get("phase", "?"),
                                                   0) + 1
        jobs.add(rec.get("job"))
        for row in rec.get("alloc", []):
            k = f"{row.get('node')}/{row.get('type')}"
            keys[k] = keys.get(k, 0) + int(row.get("count", 0))
    return {
        "decisions": len(records),
        "jobs": len(jobs),
        "by_phase": dict(sorted(phases.items())),
        "gpu_units_by_key": dict(sorted(keys.items())),
    }

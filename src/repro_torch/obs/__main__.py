"""CLI for trace and decision-log files: ``python -m repro_torch.obs``
(the port's copy of ``python -m repro.obs``).

Subcommands:

- ``summarize FILE [FILE ...]`` — per-(track, name) span statistics for
  Perfetto trace JSONs, aggregate decision statistics for ``.jsonl``
  decision logs (pass ``--explain`` to render every decision as text).
- ``merge -o OUT FILE [FILE ...]`` — concatenate several trace JSONs
  into one Perfetto-loadable document.

Exit codes: 0 success, 1 a file failed schema validation, 2 usage /
unreadable input.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from .explain import explain_allocation, load_jsonl, summarize_decisions
from .trace import merge_traces, summarize_trace, validate_trace


def _load_trace(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def _cmd_summarize(paths: List[str], explain: bool) -> int:
    rc = 0
    for path in paths:
        print(f"== {path}")
        if path.endswith(".jsonl"):
            records = load_jsonl(path)
            if explain:
                for rec in records:
                    print(explain_allocation(rec))
                    print()
            print(json.dumps(summarize_decisions(records), indent=1))
            continue
        doc = _load_trace(path)
        problems = validate_trace(doc)
        if problems:
            rc = 1
            for p in problems:
                print(f"  INVALID: {p}")
        print(json.dumps(summarize_trace(doc), indent=1))
    return rc


def _cmd_merge(paths: List[str], out: str) -> int:
    docs = [_load_trace(p) for p in paths]
    merged = merge_traces(docs)
    problems = validate_trace(merged)
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(merged, fh)
    n = sum(1 for ev in merged["traceEvents"]
            if isinstance(ev, dict) and ev.get("ph") != "M")
    print(f"merged {len(paths)} trace(s), {n} events -> {out}")
    if problems:
        for p in problems:
            print(f"  WARNING: {p}")
        return 1
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize or merge repro_torch.obs trace/decision files.")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_sum = sub.add_parser("summarize",
                           help="summarize trace JSON / decision JSONL")
    p_sum.add_argument("files", nargs="+")
    p_sum.add_argument("--explain", action="store_true",
                       help="render each decision-log record as text")

    p_merge = sub.add_parser("merge", help="merge trace JSONs into one")
    p_merge.add_argument("files", nargs="+")
    p_merge.add_argument("-o", "--out", required=True)

    ns = parser.parse_args(argv)
    try:
        if ns.cmd == "summarize":
            return _cmd_summarize(ns.files, ns.explain)
        return _cmd_merge(ns.files, ns.out)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())

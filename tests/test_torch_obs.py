"""The port's observability package (``repro_torch.obs``) against the JAX
package's (``repro.obs``), unit by unit, on the CPU.

The same seeded inputs go through both packages: histogram summaries and
quantiles, the registry summary, ``validate_trace`` / ``summarize_trace``
/ ``merge_traces`` on the reference's good and bad documents, the
decision-record schema and ``explain_allocation``'s text, the session's
install/restore, the null observer, the ``kernel_shapes`` dedupe (the
reference's ``jax_recompiles``), the environment activation and the
``python -m repro_torch.obs`` CLI's output and exit codes beside
``python -m repro.obs`` on the same files.  Last, the one change of the
port's recorder: outage spans on lanes of their own keep a faulted run's
trace valid.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import obs as jobs_
from repro.obs import explain as jexplain
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch import obs as tobs
from repro_torch.obs import explain as texplain
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace

REPO = Path(__file__).resolve().parent.parent
PKGS = ((jobs_, jmetrics, jtrace, jexplain),
        (tobs, tmetrics, ttrace, texplain))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _samples(seed: int) -> np.ndarray:
    """Consult-latency-like values over several decades, with values at
    and beyond the default bucket range's edges."""
    rng = np.random.RandomState(seed)
    vals = np.exp(rng.uniform(np.log(1e-8), np.log(1e6), size=3000))
    return np.concatenate([vals, [0.0, -1.0, 1e-7, 1e5, 1e9]])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [{}, {"lo": 1e-3, "hi": 1e3,
                                     "buckets_per_decade": 4}])
def test_histogram_summaries_and_quantiles_match(seed, kw):
    vals = _samples(seed)
    hs = [m.Histogram("lat", **kw) for _, m, _, _ in PKGS]
    for v in vals:
        for h in hs:
            h.observe(float(v))
    want, got = hs
    assert got.counts == want.counts
    assert got.to_json() == want.to_json()
    for q in np.linspace(0.0, 1.0, 41):
        assert got.quantile(float(q)) == want.quantile(float(q))
    assert tmetrics.Histogram("e").to_json() == \
        jmetrics.Histogram("e").to_json()


def test_histogram_rejects_a_bad_range():
    for _, m, _, _ in PKGS:
        with pytest.raises(ValueError):
            m.Histogram("h", lo=1.0, hi=1.0)


def test_registry_summary_matches():
    rng = np.random.RandomState(3)
    regs = [m.MetricsRegistry() for _, m, _, _ in PKGS]
    for _ in range(500):
        name = f"x{rng.randint(4)}"
        kind = rng.randint(3)
        v = float(rng.exponential())
        for reg in regs:
            if kind == 0:
                reg.counter(name).inc(int(v * 3))
            elif kind == 1:
                reg.gauge("g." + name).set(v)
            else:
                reg.histogram("h." + name).observe(v)
    want, got = regs
    assert got.names() == want.names()
    assert got.summary() == want.summary()
    json.dumps(got.summary())


def test_stopwatch_laps():
    sw = tobs.StopWatch()
    with sw:
        sum(range(1000))
    assert sw.seconds >= 0.0
    assert tobs.StopWatch().start().stop() >= 0.0


# ---------------------------------------------------------------------------
# trace documents
# ---------------------------------------------------------------------------

def _recorded(tr) -> dict:
    """One recorder's document: nested wall spans, sim spans over two runs
    (sim time restarting at 0 opens a second run's thread), instants."""
    outer = tr.now()
    inner = tr.now()
    tr.complete("inner", inner, {"k": 1})
    tr.complete("outer", outer)
    tr.instant("mark", {"n": 2})
    tr.sim_span("interval", 0.0, 360.0, {"gru": 0.5})
    tr.sim_span("interval", 360.0, 720.0, dur=360.0)
    tr.sim_instant("completion", 400.0, {"job": 3})
    tr.sim_span("interval", 0.0, 90.0)
    return tr.to_json()


def _documents():
    """The reference's good and bad documents (``tests/test_obs.py``) and
    one of its recorder's."""
    good = _recorded(jtrace.TraceRecorder())
    return {
        "recorded": good,
        "empty": {},
        "not_a_list": {"traceEvents": {}},
        "not_an_object": {"traceEvents": [3]},
        "missing_name": {"traceEvents": [{"ph": "X", "pid": 1, "ts": 0.0,
                                          "dur": 1.0}]},
        "bad_dur": {"traceEvents": [{"name": "a", "ph": "X", "pid": 1,
                                     "ts": 0.0, "dur": -5.0}]},
        "overlap": {"traceEvents": [
            {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0,
             "dur": 10.0},
            {"name": "b", "ph": "X", "pid": 1, "tid": 1, "ts": 5.0,
             "dur": 10.0}]},
        "nested": {"traceEvents": [
            {"name": "p", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0,
             "dur": 10.0},
            {"name": "c", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0,
             "dur": 4.0},
            {"name": "n", "ph": "X", "pid": 1, "tid": 1, "ts": 10.0,
             "dur": 5.0},
            {"name": "m", "ph": "M", "pid": 1}]},
    }


@pytest.mark.parametrize("name", list(_documents()))
def test_validate_and_summarize_match_on_reference_documents(name):
    doc = _documents()[name]
    assert ttrace.validate_trace(doc) == jtrace.validate_trace(doc)
    if isinstance(doc.get("traceEvents", []), list):
        assert ttrace.summarize_trace(doc) == jtrace.summarize_trace(doc)


def test_recorders_write_the_reference_sim_track():
    """Fed the same calls, the two recorders give the same sim-track
    events and metadata (wall timestamps are the host clock's)."""
    want = _recorded(jtrace.TraceRecorder())
    got = _recorded(ttrace.TraceRecorder())

    def sim(doc):
        return [e for e in doc["traceEvents"]
                if e.get("pid") == jtrace.SIM_PID or e["ph"] == "M"]
    assert sim(got) == sim(want)
    assert [(e["name"], e["ph"]) for e in got["traceEvents"]] == \
        [(e["name"], e["ph"]) for e in want["traceEvents"]]
    assert ttrace.validate_trace(got) == []


def test_merge_traces_matches():
    docs = []
    for t0 in (0.0, 1.0):
        tr = jtrace.TraceRecorder()
        tr.sim_span("x", t0, t0 + 1.0)
        tr.sim_instant("i", t0)
        docs.append(tr.to_json())
    docs.append(_documents()["nested"])
    got = ttrace.merge_traces(docs)
    assert got == jtrace.merge_traces(docs)
    assert ttrace.validate_trace(got) == []
    assert sum(e.get("ph") == "M" for e in got["traceEvents"]) == 3


def test_outage_lanes_keep_a_faulted_trace_valid():
    """A node outage that ends inside a round: the reference puts its span
    on the run's own thread, where it partially overlaps the round's
    interval; the port puts it on the node's lane (a thread of the run's
    own), same name, ts, dur and args, and the trace validates."""
    docs = []
    for obs in (jobs_, tobs):
        ob = obs.Observer(metrics=False, decisions=False)
        ob.interval("rounds", 0.0, 360.0, 1.0, 1.0, 1, 0, 0)
        ob.fault("node_fail", 360.0, 4, 500.0)
        ob.fault("spot_preempt", 360.0, 5, 900.0)
        ob.interval("rounds", 360.0, 360.0, 0.5, 0.5, 1, 1, 1)
        ob.interval("rounds", 720.0, 360.0, 0.5, 0.5, 1, 1, 0)
        ob.interval("rounds", 0.0, 360.0, 1.0, 1.0, 1, 0, 0)   # run 2
        ob.fault("node_fail", 0.0, 4, 100.0)
        docs.append(ob.trace.to_json())
    want, got = docs
    assert jtrace.validate_trace(want) != []
    assert ttrace.validate_trace(got) == []

    def spans(doc):
        return [(e["name"], e["ts"], e["dur"], e["args"])
                for e in doc["traceEvents"] if e["ph"] == "X"]
    assert spans(got) == spans(want)
    lanes = {e["tid"] for e in got["traceEvents"]
             if e["ph"] == "X" and e["name"].startswith("fault.")}
    assert len(lanes) == 3 and min(lanes) >= ttrace.LANE_TID0
    names = {e["args"]["name"] for e in got["traceEvents"]
             if e["name"] == "thread_name"}
    assert {"run 1", "run 2", "run 1 node 4", "run 1 node 5",
            "run 2 node 4"} <= names


# ---------------------------------------------------------------------------
# decision log / explain
# ---------------------------------------------------------------------------

RUNNER_UPS = [None, {"kind": "pack", "node": 5, "payoff": 1.2},
              {"kind": "spread", "prefix": 2, "n_servers": 3,
               "payoff": 1.0}]


def _records(explain):
    rows = [{"node": 3, "type": "v100", "count": 2, "unit_price": 0.25,
             "gamma": 1, "cap": 4, "u_min": 0.1, "u_max": 2.0},
            {"node": 3, "type": "k80", "count": 1,
             "unit_price": 0.1 * 20.0 ** 0.5, "gamma": 2, "cap": 4,
             "u_min": 0.1, "u_max": 2.0}]
    out = []
    for i, ru in enumerate(RUNNER_UPS):
        for phase, payoff in (("dp", 1.5), ("backfill", -0.25),
                              ("backfill", 0.75)):
            out.append(explain.decision_record(
                360.0 * i, 7 + i, 3, phase, ("numpy", None)[i % 2], rows,
                cost=0.5, payoff=payoff, rate=2.0 / 3.0, runner_up=ru))
    out.append(explain.eviction_record(720.0, 9, 4, "node_fail", [3, 4],
                                       123.5, 61.75, 8.0, 0))
    return out


def test_decision_records_and_text_match():
    want, got = _records(jexplain), _records(texplain)
    assert got == want
    for a, b in zip(got, want):
        assert list(a) == list(b)                  # key order, too
        assert texplain.explain_allocation(a) == \
            jexplain.explain_allocation(b)
    assert texplain.summarize_decisions(got) == \
        jexplain.summarize_decisions(want)


def test_decision_log_jsonl_roundtrip(tmp_path):
    log = tobs.DecisionLog()
    for rec in _records(texplain):
        log.record(rec)
    path = tmp_path / "d.jsonl"
    log.save_jsonl(str(path))
    assert texplain.load_jsonl(str(path)) == log.decisions
    assert jexplain.load_jsonl(str(path)) == log.decisions
    assert len(log) == len(RUNNER_UPS) * 3 + 1


# ---------------------------------------------------------------------------
# observer lifecycle
# ---------------------------------------------------------------------------

def test_session_installs_and_restores(tmp_path):
    assert tobs.get() is tobs.NULL and not tobs.enabled()
    paths = {k: tmp_path / f"{k}.json" for k in ("t", "d", "m")}
    with tobs.session(trace_path=str(paths["t"]),
                      decisions_path=str(paths["d"]),
                      metrics_path=str(paths["m"])) as ob:
        assert tobs.get() is ob and tobs.enabled()
        with tobs.session(trace=False, decisions=False) as inner:
            assert tobs.get() is inner and inner.trace is None
        assert tobs.get() is ob
        ob.count("x")
        ob.observe("lat", 0.01)
        ob.decision(_records(texplain)[0])
        with ob.consult("events", "hadar", 0.0, 3) as sw:
            pass
        assert sw.seconds >= 0.0
    assert tobs.get() is tobs.NULL
    assert ttrace.validate_trace(json.loads(paths["t"].read_text())) == []
    assert len(texplain.load_jsonl(str(paths["d"]))) == 1
    summary = json.loads(paths["m"].read_text())
    assert summary["counters"] == {"consults": 1, "decisions": 1, "x": 1}
    assert summary["histograms"]["decision_latency_s"]["count"] == 1
    ob.close()                                     # idempotent
    assert not jobs_.enabled()                     # the reference untouched


def test_session_restores_on_error():
    with pytest.raises(KeyError):
        with tobs.session():
            raise KeyError("x")
    assert tobs.get() is tobs.NULL


def test_null_observer_hooks_are_noops():
    nul = tobs.NULL
    assert not nul.enabled and nul.trace is None and nul.metrics is None \
        and nul.decisions is None
    with nul.consult("events", "hadar", 0.0, 0) as sw:
        pass
    assert isinstance(sw, tobs.StopWatch) and sw.seconds >= 0.0
    nul.close()


def test_kernel_shapes_count_distinct_shapes_once():
    keys = [(5, 3, 0.05, 8, 15, 4), (5, 3, 0.05, 8, 15, 4),
            (5, 3, 0.05, 16, 15, 4),
            ("commit_scan", 5, 3, 0.05, 16, 15, 4, 8),
            ("commit_scan", 5, 3, 0.05, 16, 15, 4, 8)]
    counts = []
    for obs, name in ((jobs_, "jax_recompiles"), (tobs, "kernel_shapes")):
        ob = obs.Observer(trace=False, decisions=False)
        for k in keys:
            ob.kernel_shape(k)
        counts.append(ob.metrics.counter(name).value)
    assert counts == [3, 3]


ACTIVATE = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch import obs
print(obs.enabled())
ob = obs.get()
if ob.enabled:
    ob.count("x")
    ob.sim_span("interval", 0.0, 1.0)
"""


@pytest.mark.parametrize("env", [{}, {"REPRO_OBS": "1"},
                                 {"REPRO_OBS": "off"}, "files"])
def test_environment_activation(tmp_path, env):
    """The JAX package's variables install the port's observer at import;
    the named files are written at exit."""
    files = env == "files"
    if files:
        env = {"REPRO_OBS_TRACE": str(tmp_path / "t.json"),
               "REPRO_OBS_METRICS": str(tmp_path / "m.json"),
               "REPRO_OBS_DECISIONS": str(tmp_path / "d.jsonl")}
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("REPRO_OBS")}
    proc = subprocess.run(
        [sys.executable, "-c", ACTIVATE], capture_output=True, text=True,
        cwd=REPO, env={**base, "PYTHONPATH": str(REPO / "src"), **env},
        timeout=60)
    assert proc.returncode == 0, proc.stderr
    on = files or env.get("REPRO_OBS") == "1"
    assert proc.stdout.split() == [str(on)]
    if files:
        doc = json.loads((tmp_path / "t.json").read_text())
        assert ttrace.validate_trace(doc) == []
        assert json.loads((tmp_path / "m.json").read_text())[
            "counters"] == {"x": 1}
        assert (tmp_path / "d.jsonl").read_text() == ""


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cli(module: str, *args):
    return subprocess.run(
        [sys.executable, "-m", module, *args], capture_output=True,
        text=True, cwd=str(REPO), timeout=60,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    out = {}
    for name, doc in (("good", _recorded(jtrace.TraceRecorder())),
                      ("overlap", _documents()["overlap"]),
                      ("empty", {})):
        out[name] = d / f"{name}.json"
        out[name].write_text(json.dumps(doc))
    out["log"] = d / "d.jsonl"
    out["log"].write_text("".join(json.dumps(r) + "\n"
                                  for r in _records(jexplain)))
    out["junk"] = d / "junk.json"
    out["junk"].write_text("{not json")
    out["dir"] = d
    return out


CLI_CASES = {
    "summarize": ("summarize", "good", "log"),
    "explain": ("summarize", "log", "good", "--explain"),
    "invalid": ("summarize", "good", "overlap"),
    "empty": ("summarize", "empty"),
    "missing": ("summarize", "nothing"),
    "junk": ("summarize", "junk"),
    "merge": ("merge", "-o", "OUT", "good", "good"),
    "merge_invalid": ("merge", "-o", "OUT", "good", "overlap"),
    "merge_missing": ("merge", "-o", "OUT", "nothing"),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_matches_reference(files, case):
    outs = []
    for module in ("repro.obs", "repro_torch.obs"):
        out_path = files["dir"] / f"merged_{module}.json"
        out_path.unlink(missing_ok=True)
        args = [str(out_path) if a == "OUT" else
                str(files[a]) if a in files else
                str(files["dir"] / a) if a == "nothing" else a
                for a in CLI_CASES[case]]
        proc = _cli(module, *args)
        merged = json.loads(out_path.read_text()) \
            if case.startswith("merge") and out_path.exists() else None
        outs.append((proc.returncode,
                     proc.stdout.replace(str(out_path), "OUT"), merged))
    want, got = outs
    assert got == want
    assert got[0] == {"summarize": 0, "explain": 0, "invalid": 1,
                      "empty": 1, "missing": 2, "junk": 2, "merge": 0,
                      "merge_invalid": 1, "merge_missing": 2}[case]


def test_cli_usage_errors_exit_2():
    for args in ((), ("merge", "x.json"), ("bogus",)):
        proc = _cli("repro_torch.obs", *args)
        assert proc.returncode == 2
        assert "python -m repro_torch.obs" in proc.stderr


def test_histogram_quantiles_within_one_bucket_of_exact():
    """The port's streaming quantiles against exact percentiles: within
    one bucket's factor, as the reference's property test holds its own."""
    vals = np.exp(np.random.RandomState(4).uniform(np.log(1e-5),
                                                   np.log(10.0), 5000))
    h = tmetrics.Histogram("lat")
    for v in vals:
        h.observe(float(v))
    factor = 10.0 ** (1.0 / h.bpd)
    for q in (0.5, 0.95, 0.99):
        exact = float(np.percentile(vals, q * 100))
        assert exact / factor <= h.quantile(q) <= exact * factor
    assert math.isclose(h.mean(), float(vals.mean()), rel_tol=1e-12)


def test_kernel_builds_count_first_loads(monkeypatch):
    """``kernels/build.py`` counts each library's first load in the
    process on the observer (the reference's ``jax_kernel_builds``); the
    build and the load are stubbed: there is no nvcc here."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "build_all",
                        lambda names: {n: Path(f"lib{n}.so") for n in names})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    build.load("find_alloc")                       # observer off
    with tobs.session(trace=False, decisions=False) as ob:
        for name in ("find_alloc", "commit_scan", "commit_scan", "rmsnorm"):
            build.load(name)
    assert ob.metrics.summary()["counters"] == {"kernel_builds": 2}

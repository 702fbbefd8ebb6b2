"""The port's observability hooks against the JAX package's, on the CPU.

Each scenario runs the same seeded trace through both packages under an
observer session, Hadar with ``solver="numpy"`` on both sides (the
reference scheduler built here): the round and event engines, HadarE
(``simulate_hadare``), an env episode and a ``compare`` table, each under
faults.  The decision logs must be equal in every field, the counters,
gauges and deterministic histograms equal (every histogram but the host
clock's ``decision_latency_s``), the sim-track events equal in name,
``ts``, ``dur`` and args (the consult instant's ``wall_ms`` is the host
clock's), and the wall-track events equal in name and count.

Then the port alone: every result bitwise the same with the observer on
and off, on ``numpy`` and on the batched path (``solver="cuda",
device="cpu"``: the kernels' plain versions); the batched path's
decision log equal to the NumPy path's, runner-ups included, with K4's
and K5's calls counted; the sanitizer's ``invariant_checks.*`` counters
those of the reference; and the smoke's phase-obs gate
(``chip_smoke.check_observed``) on 12 jobs, passing and catching planted
faults.
"""
import copy
import importlib.util
import json
import math
from collections import Counter
from pathlib import Path

import pytest

import repro.env.compare as jcmp
import repro_torch.env.compare as tcmp
from repro import obs as jobs_
from repro.core import trace as jtrace
from repro.core.hadar import HadarScheduler as JHadar
from repro.core.types import Cluster as JCluster
from repro.core.types import Node as JNode
from repro.env import env as jenv
from repro.sim import adapters as jadapters
from repro.sim import engine as jengine
from repro.sim import faults as jfaults
from repro_torch import obs as tobs
from repro_torch.core import trace as ttrace
from repro_torch.core.hadar import HadarScheduler
from repro_torch.env import env as tenv
from repro_torch.sim import adapters as tadapters
from repro_torch.sim import engine as tengine
from repro_torch.sim import faults as tfaults
from repro_torch.sim.metrics import result_fields

# dense enough in faults that 10 jobs see failures, spot reclaims,
# recoveries and evictions in each engine
MODEL = dict(seed=5, mtbf_hours=6.0, spot_frac=0.3, spot_reclaim_hours=4.0)
# the two packages' modules, in the order (reference, port)
SIDES = ({"obs": jobs_, "trace": jtrace, "faults": jfaults,
          "engine": jengine, "adapters": jadapters, "env": jenv,
          "cmp": jcmp, "device": {},
          "hadar": lambda solver, **kw: JHadar(solver=solver, **kw)},
         {"obs": tobs, "trace": ttrace, "faults": tfaults,
          "engine": tengine, "adapters": tadapters, "env": tenv,
          "cmp": tcmp, "device": {"device": "cpu"},
          "hadar": lambda solver, **kw: HadarScheduler(
              solver=solver, device="cpu", **kw)})


def _rounds(p, solver, **kw):
    cl = p["trace"].simulation_cluster()
    return p["engine"].simulate_rounds(
        p["hadar"](solver, **kw), p["trace"].philly_trace(n_jobs=10, seed=3),
        cl, faults=p["faults"].FailureModel(**MODEL))


def _events(p, solver, **kw):
    cl = p["trace"].simulation_cluster()
    return p["engine"].simulate_events(
        p["hadar"](solver, **kw), p["trace"].philly_trace(n_jobs=10, seed=3),
        cl, faults=p["faults"].FailureModel(**MODEL))


def _hadare(p, solver, **kw):
    cl = p["trace"].testbed_cluster()
    outage = p["faults"].FailureTrace([(0, 100.0, 400.0),
                                       (1, 100.0, 1000.0)])
    return p["adapters"].simulate_hadare(
        p["trace"].mix_jobs("M-5", cl), cl, round_len=90.0, faults=outage,
        scheduler=p["hadar"](solver, **kw))


def _env(p, solver, **kw):
    cl = p["trace"].simulation_cluster()
    env = p["env"].ClusterSchedulingEnv(
        p["trace"].philly_trace(n_jobs=10, seed=4), cl,
        faults=p["faults"].FailureModel(**MODEL), reward="neg_jct")
    res, rewards = p["env"].run_policy(env, p["hadar"](solver, **kw))
    return res


def _compare(p, solver):
    return p["cmp"].compare(
        p["trace"].philly_trace(n_jobs=8, seed=2),
        p["trace"].simulation_cluster(),
        ("hadar", "hadare", "fcfs", "gavel", "tiresias"), solver=solver,
        faults=p["faults"].FailureModel(**MODEL), **p["device"])


SCENARIOS = {"rounds": _rounds, "events": _events, "hadare": _hadare,
             "env": _env, "compare": _compare}


def _observed(side: int, scenario: str, solver: str = "numpy", **kw):
    p = SIDES[side]
    with p["obs"].session() as ob:
        out = SCENARIOS[scenario](p, solver, **kw)
    return ob, out


def _sim_events(ob):
    out = []
    for e in ob.trace.events:
        if e["pid"] != jobs_.SIM_PID:
            continue
        args = {k: v for k, v in e["args"].items() if k != "wall_ms"}
        out.append((e["name"], e["ph"], e["ts"], e.get("dur"), args))
    return out


def _assert_same_artifacts(want, got):
    assert got.decisions.decisions == want.decisions.decisions
    sw, sg = want.metrics.summary(), got.metrics.summary()
    assert sg["counters"] == sw["counters"]
    assert sg["gauges"] == sw["gauges"]
    hist = [k for k in sw["histograms"] if k != "decision_latency_s"]
    assert sorted(sg["histograms"]) == sorted(sw["histograms"])
    assert {k: sg["histograms"][k] for k in hist} == \
        {k: sw["histograms"][k] for k in hist}
    assert _sim_events(got) == _sim_events(want)
    wall = [Counter(e["name"] for e in ob.trace.events
                    if e["pid"] == jobs_.WALL_PID) for ob in (want, got)]
    assert wall[1] == wall[0]
    assert tobs.validate_trace(got.trace.to_json()) == []


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_artifacts_match_jax_package(scenario):
    want, wres = _observed(0, scenario)
    got, gres = _observed(1, scenario)
    _assert_same_artifacts(want, got)
    counters = got.metrics.summary()["counters"]
    assert counters["decisions"] > 0
    # an env episode steps event_stream itself: no engine consult span
    assert (counters.get("consults", 0) > 0) == (scenario != "env")
    assert any(k.startswith("faults.") for k in counters)
    assert any(r["runner_up"] for r in got.decisions.decisions
               if r["phase"] != "eviction")
    if scenario == "compare":
        assert gres == wres
        assert Counter(e["name"] for e in got.trace.events)[
            "compare.policy"] == 5
    else:
        assert result_fields(gres) == result_fields(wres)


def _fields(scenario, out):
    return out if scenario == "compare" else result_fields(out)


@pytest.mark.parametrize("solver", ["numpy", "cuda"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_results_bit_identical_with_observer_on_and_off(scenario, solver):
    plain = SCENARIOS[scenario](SIDES[1], solver)
    ob, observed = _observed(1, scenario, solver)
    assert _fields(scenario, observed) == _fields(scenario, plain)
    assert ob.metrics.counter("decisions").value > 0


def test_batched_path_logs_the_numpy_path_decisions():
    """Hadar on the batched path (the kernels' plain versions) under the
    observer, with ``max_exact_dp=4`` so the 10-job queues take the
    greedy commit through waves and K5: its decision log is the NumPy
    path's, runner-ups included, and K4's and K5's calls are counted."""
    logs, counters = {}, {}
    for solver in ("numpy", "cuda"):
        ob, _ = _observed(1, "rounds", solver, max_exact_dp=4)
        logs[solver] = [{k: v for k, v in r.items() if k != "solver"}
                        for r in ob.decisions.decisions]
        counters[solver] = ob.metrics.summary()["counters"]
    assert logs["cuda"] == logs["numpy"]
    assert sum(1 for r in logs["cuda"] if r.get("runner_up")) > 10
    got = counters["cuda"]
    assert got["solver_batch_calls"] >= 1
    assert got["solver_scan_calls"] >= 1
    assert got["kernel_shapes"] >= 1 and got["solver.commit_waves"] >= 1
    assert not any(k.startswith(("solver_", "kernel_"))
                   for k in counters["numpy"])
    shared = {k: v for k, v in got.items()
              if not k.startswith(("solver", "kernel_"))}
    assert shared == counters["numpy"]


def test_batched_path_logs_runner_ups_of_the_exact_dp():
    """On queues within ``max_exact_dp`` the batched path seeds the exact
    DP from one K4 call: its log equals the NumPy path's too."""
    logs = {}
    for solver in ("numpy", "cuda"):
        ob, _ = _observed(1, "events", solver)
        logs[solver] = [{k: v for k, v in r.items() if k != "solver"}
                        for r in ob.decisions.decisions]
        if solver == "cuda":
            assert ob.metrics.counter("solver_batch_calls").value >= 1
            assert ob.metrics.counter("kernel_shapes").value >= 1
    assert logs["cuda"] == logs["numpy"]


def test_invariant_check_counters_tick_under_sanitize(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    want, _ = _observed(0, "events")
    got, _ = _observed(1, "events")
    ticks = [{k: v for k, v in ob.metrics.summary()["counters"].items()
              if k.startswith("invariant_checks.")} for ob in (want, got)]
    assert ticks[1] == ticks[0]
    assert {"invariant_checks.cluster_allocs", "invariant_checks.progress",
            "invariant_checks.monotonic"} <= set(ticks[1])


# ---------------------------------------------------------------------------
# the smoke's phase-obs gate, on the CPU at 12 jobs
# ---------------------------------------------------------------------------

def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_counts(smoke, engine: str) -> dict:
    """The JAX package's counts for the run ``run_observed`` makes, as
    REF_OBS holds them for the smoke's runs."""
    tcl = ttrace.grown_cluster(12)
    cl = JCluster([JNode(n.node_id, dict(n.gpus)) for n in tcl.nodes])
    jobs = jtrace.philly_trace(n_jobs=12, seed=1, types=cl.gpu_types)
    model = jfaults.FailureModel(**MODEL)
    with jobs_.session() as ob:
        if engine == "hadare":
            jadapters.simulate_hadare(jobs, cl, faults=model,
                                      scheduler=JHadar(solver="numpy"),
                                      round_len=smoke.OBS_ROUND)
        else:
            jengine.simulate_rounds(JHadar(solver="numpy"), jobs, cl,
                                    faults=model, round_len=smoke.OBS_ROUND)
    return smoke.obs_counts({"metrics": ob.metrics.summary(),
                             "trace": ob.trace.to_json()})


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    """``chip_smoke.run_observed`` of 12 fig5 jobs under MODEL for both
    engines and solvers (the kernels' plain versions), the unobserved
    batched run of each, and the JAX package's counts."""
    smoke = _smoke()
    tmp = tmp_path_factory.mktemp("obs")
    cl = ttrace.grown_cluster(12)
    jobs = ttrace.philly_trace(n_jobs=12, seed=1, types=cl.gpu_types)
    out = {}
    for engine in ("rounds", "hadare"):
        runs = {s: smoke.run_observed(engine, s, jobs, cl,
                                      tfaults.FailureModel(**MODEL), tmp,
                                      device="cpu",
                                      round_len=smoke.OBS_ROUND)
                for s in ("cuda", "numpy")}
        sched = HadarScheduler(solver="cuda", device="cpu")
        model = tfaults.FailureModel(**MODEL)
        if engine == "hadare":
            res = tadapters.simulate_hadare(ttrace.philly_trace(
                n_jobs=12, seed=1, types=cl.gpu_types), cl, faults=model,
                scheduler=sched, round_len=smoke.OBS_ROUND)
        else:
            res = tengine.simulate_rounds(sched, ttrace.philly_trace(
                n_jobs=12, seed=1, types=cl.gpu_types), cl, faults=model,
                round_len=smoke.OBS_ROUND)
        plain = {"fields": result_fields(res),
                 "launches": smoke.read_launches(), "wall_s": 0.0}
        out[engine] = (runs, plain, _reference_counts(smoke, engine))
    return smoke, out


@pytest.mark.parametrize("engine", ["rounds", "hadare"])
def test_smoke_check_observed_passes(smoke_runs, engine):
    smoke, runs = smoke_runs
    (run, plain, want) = runs[engine]
    row = smoke.check_observed(engine, run["cuda"], plain, run["numpy"],
                               want, smoke.OBS_ROUND)
    assert row["records"] > 0 and row["runner_ups"] > 0
    assert row["intervals_held"] > 0
    assert row["counts"]["faults.evictions"] > 0
    assert (row["counts"]["hadare.consolidation"] > 0) == \
        (engine == "hadare")
    assert row["spans"]["consult"]["count"] == row["counts"]["consults"]
    json.dumps(row)


def _spoil(run, what):
    run = copy.deepcopy({k: v for k, v in run.items() if k != "res"}) | {
        "res": run["res"]}
    decisions = [r for r in run["decisions"] if r["phase"] != "eviction"]
    rec = next(r for r in decisions if r["runner_up"])
    if what == "price":
        rec["alloc"][0]["unit_price"] *= 1 + 1e-15
    elif what == "runner_up_above":
        rec["runner_up"]["payoff"] = rec["payoff"] + 1.0
    elif what == "runner_up_kind":
        rec["runner_up"]["kind"] = ("spread" if rec["runner_up"]["kind"]
                                    == "pack" else "pack")
    elif what == "runner_up_two_ulps":
        p = rec["runner_up"]["payoff"]
        rec["runner_up"]["payoff"] = math.nextafter(
            math.nextafter(p, -math.inf), -math.inf)
    elif what == "count":
        run["metrics"]["counters"]["consults"] += 1
    elif what == "interval":
        span = next(e for e in run["trace"]["traceEvents"]
                    if e["name"] == "interval")
        span["dur"] = span["dur"] * (1 + 2.0 ** -50)
    elif what == "overlap":
        span = next(e for e in run["trace"]["traceEvents"]
                    if e["name"].startswith("fault.") and e["ph"] == "X")
        span["tid"] = 1
    elif what == "launches":
        run["launches"] = dict(run["launches"], find_alloc=1)
    return run


@pytest.mark.parametrize("what", ["price", "runner_up_above",
                                  "runner_up_kind", "runner_up_two_ulps",
                                  "count", "interval", "overlap",
                                  "launches"])
def test_smoke_check_observed_catches_planted_faults(smoke_runs, what):
    smoke, runs = smoke_runs
    (run, plain, want) = runs["rounds"]
    with pytest.raises(RuntimeError, match="obs rounds"):
        smoke.check_observed("rounds", _spoil(run["cuda"], what), plain,
                             run["numpy"], want, smoke.OBS_ROUND)

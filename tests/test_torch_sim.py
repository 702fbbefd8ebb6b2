"""The port's event engine, fault model and trace replay against the JAX
package's, on the CPU.

The same inputs, built from fixed seeds for both packages, go through
``repro.sim`` and ``repro_torch.sim``: the event queue's pops, the failure
model's windows, checkpoint rollback and eviction choices, the job and
failure-trace CSVs, and whole runs of both engines with and without
faults.  Hadar runs in both packages with ``solver="numpy"`` (the
reference scheduler is built here; no ``solver=`` goes to the reference
engines), at <= 16 jobs or on ``examples/traces/philly_mini.csv`` (12
jobs), including a window that takes every K80 node of
``simulation_cluster()`` down at once, so the view loses a GPU type.
Results are compared in every field but ``sched_seconds`` (host time).
"""
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest

from repro.core import trace as jtrace
from repro.core.hadar import HadarScheduler as JHadar
from repro.core.types import Cluster as JCluster
from repro.core.types import Job as JJob
from repro.core.types import Node as JNode
from repro.sim import engine as jengine
from repro.sim import events as jevents
from repro.sim import faults as jfaults
from repro.sim import replay as jreplay
from repro_torch.core import batch_solver as tbs
from repro_torch.core import trace as ttrace
from repro_torch.core.hadar import HadarScheduler
from repro_torch.core.types import Cluster, Job, Node
from repro_torch.sim import engine as tengine
from repro_torch.sim import events as tevents
from repro_torch.sim import faults as tfaults
from repro_torch.sim.metrics import result_fields
from repro_torch.sim import replay as treplay

REPO = Path(__file__).resolve().parent.parent
MINI = REPO / "examples" / "traces" / "philly_mini.csv"
MINI_FAULTS = REPO / "examples" / "traces" / "philly_mini_faults.csv"
TYPES = ["v100", "p100", "k80"]
# every K80 node of simulation_cluster() (nodes 10-14) down together, over
# four arrivals of philly_mini; and every V100 node while jobs run there
K80_OUTAGE = [(n, 7200.0, 40000.0, "fail") for n in range(10, 15)]
V100_OUTAGE = [(n, 1000.0, 20000.0, "fail") for n in range(0, 5)]


def _windows(trace):
    return [dataclasses.astuple(w) for w in trace]


def _clusters(kind):
    """(reference cluster, port cluster) of the same geometry."""
    if kind == "sim":
        return jtrace.simulation_cluster(), ttrace.simulation_cluster()
    if kind == "grown":
        nodes = [(i, {TYPES[i % 3]: 4}) for i in range(15)]
    else:                                           # "mixed": 2-type nodes
        nodes = [(i, {TYPES[i % 3]: 2, TYPES[(i + 1) % 3]: 1 + i % 2})
                 for i in range(9)]
    return (JCluster([JNode(i, dict(g)) for i, g in nodes]),
            Cluster([Node(i, dict(g)) for i, g in nodes]))


# ---------------------------------------------------------------------------
# the event queue
# ---------------------------------------------------------------------------

def _queue_ops(seed, n=300):
    """A seeded random sequence of queue operations, with times from a
    small set so that ties of every kind occur."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n):
        r = rng.rand()
        t = float(rng.choice([0.0, 1.0, 2.5, 2.5, 4.0, 7.0]))
        if r < 0.2:
            ops.append(("arrival", t, int(rng.randint(0, 8))))
        elif r < 0.4:
            ops.append(("completion", t, int(rng.randint(0, 8))))
        elif r < 0.5:
            ops.append(("invalidate", int(rng.randint(0, 8))))
        elif r < 0.65:
            ops.append(("fault", t, int(rng.choice([2, 3, 4])),
                        int(rng.randint(0, 5))))
        elif r < 0.75:
            ops.append(("reschedule", t))
        elif r < 0.9:
            ops.append(("pop",))
        else:
            ops.append(("peek",))
    return ops + [("pop",)] * 40


def _replay_queue(mod, ops):
    q = mod.EventQueue()
    out = []
    for op in ops:
        if op[0] == "arrival":
            q.push_arrival(op[1], op[2])
        elif op[0] == "completion":
            q.push_completion(op[1], op[2])
        elif op[0] == "invalidate":
            q.invalidate_completion(op[1])
        elif op[0] == "fault":
            q.push_fault(op[1], mod.EventKind(op[2]), op[3])
        elif op[0] == "reschedule":
            q.push_reschedule(op[1])
        elif op[0] == "peek":
            out.append(("peek", q.peek_time(), len(q), bool(q)))
        else:
            out.append(("pop", [(e.time, int(e.kind), e.job_id, e.node_id)
                                for e in q.pop_batch()]))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_event_queue_pops_match_jax_package(seed):
    ops = _queue_ops(seed)
    want = _replay_queue(jevents, ops)
    got = _replay_queue(tevents, ops)
    assert got == want
    kinds = {k for o in want if o[0] == "pop" for _, k, _, _ in o[1]}
    assert kinds == {int(k) for k in tevents.EventKind}


def test_event_kinds_and_fault_kinds_match_jax_package():
    assert [(k.name, int(k)) for k in tevents.EventKind] == \
        [(k.name, int(k)) for k in jevents.EventKind]
    assert {int(k) for k in tevents.FAULT_KINDS} == \
        {int(k) for k in jevents.FAULT_KINDS}
    for mod in (jevents, tevents):
        with pytest.raises(ValueError, match="non-fault kind"):
            mod.EventQueue().push_fault(0.0, mod.EventKind.COMPLETION, 0)


# ---------------------------------------------------------------------------
# the failure model
# ---------------------------------------------------------------------------

MODELS = [
    dict(seed=7, mtbf_hours=72.0, spot_frac=0.2, spot_reclaim_hours=24.0),
    dict(seed=1, mtbf_hours=4.0, recovery_s=600.0, recovery_dist="uniform",
         horizon=48 * 3600.0),
    dict(seed=2, mtbf_hours={"k80": 2.0, "p100": 5.0},
         recovery_dist="exponential", horizon=72 * 3600.0),
    dict(seed=3, mtbf_hours=1e9, spot_nodes=[0, 4], spot_reclaim_hours=6.0,
         spot_recovery_s=120.0, recovery_dist="exponential",
         horizon=72 * 3600.0),
    dict(seed=11, mtbf_hours=12.0, spot_frac=0.5, recovery_dist="fixed",
         recovery_s=1800.0, checkpoint_interval=300.0),
]


@pytest.mark.parametrize("kw", MODELS)
@pytest.mark.parametrize("kind", ["sim", "mixed"])
def test_failure_model_windows_match_jax_package(kw, kind):
    jcl, tcl = _clusters(kind)
    want = jfaults.FailureModel(**kw).sample(jcl)
    got = tfaults.FailureModel(**kw).sample(tcl)
    assert _windows(got) == _windows(want) and len(want) > 0
    # per-node streams: sampling a sub-cluster == restricting
    sub = [n.node_id for n in tcl.nodes[:4]]
    assert _windows(got.restrict(sub)) == _windows(want.restrict(sub))
    assert _windows(tfaults.FailureModel(**kw).sample(
        Cluster([n for n in tcl.nodes if n.node_id in sub]))) == \
        _windows(want.restrict(sub))
    assert _windows(tfaults.resolve_faults(tfaults.FailureModel(**kw),
                                           tcl)) == _windows(want)
    for f in (None, 123.0):
        assert tfaults.resolve_checkpoint_interval(
            f, tfaults.FailureModel(**kw)) == \
            jfaults.resolve_checkpoint_interval(
                f, jfaults.FailureModel(**kw))


def test_failure_model_on_the_smoke_cluster_matches_jax_package():
    """The smoke's event phase: grown_cluster(256), 32 nodes."""
    kw = MODELS[0]
    jcl = JCluster([JNode(i, {TYPES[i % 3]: 4}) for i in range(32)])
    want = jfaults.FailureModel(**kw).sample(jcl)
    got = tfaults.FailureModel(**kw).sample(ttrace.grown_cluster(256))
    assert _windows(got) == _windows(want)
    assert sum(w.kind == "spot" for w in got) > 0


BAD_WINDOWS = [
    [(0, 10.0, 5.0)],
    [(0, -1.0, 5.0)],
    [(0, 1.0, 2.0, "meteor")],
    [(99, 1.0, 2.0)],
    [(0, 1.0, 5.0), (0, 4.0, 9.0)],
    [(3, 0.0, math.inf), (3, 100.0, 200.0)],
]


@pytest.mark.parametrize("bad", BAD_WINDOWS)
def test_failure_trace_rejects_what_the_jax_package_rejects(bad):
    jcl, tcl = _clusters("sim")
    with pytest.raises(ValueError) as want:
        jfaults.FailureTrace(bad, jcl)
    with pytest.raises(ValueError) as got:
        tfaults.FailureTrace(bad, tcl)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(mtbf_hours=0.0), dict(mtbf_hours={"k80": -1.0}),
    dict(recovery_dist="lognormal"), dict(spot_reclaim_hours=0.0),
    dict(spot_frac=1.5)])
def test_failure_model_rejects_what_the_jax_package_rejects(kw):
    with pytest.raises(ValueError) as want:
        jfaults.FailureModel(**kw)
    with pytest.raises(ValueError) as got:
        tfaults.FailureModel(**kw)
    assert str(got.value) == str(want.value)


def test_failure_trace_orders_and_restricts_as_jax_package():
    ws = [(4, 5.0, 9.0), (0, 5.0, 9.0), (0, 1.0, 5.0), (2, 3.0),
          (1, 3.0, 4.0, "spot")]
    want, got = jfaults.FailureTrace(ws), tfaults.FailureTrace(ws)
    assert _windows(got) == _windows(want)
    assert _windows(got.restrict([0, 2])) == _windows(want.restrict([0, 2]))
    assert got == tfaults.FailureTrace(list(reversed(ws)))
    assert len(tfaults.resolve_faults(ws, Cluster(
        [Node(i, {"v100": 1}) for i in range(5)]))) == 5


@pytest.mark.parametrize("seed", range(4))
def test_rollback_point_matches_jax_package(seed):
    rng = np.random.RandomState(seed)
    for _ in range(200):
        done0 = float(rng.choice([0.0, rng.uniform(0, 500)]))
        rate = float(rng.choice([0.0, rng.uniform(0.1, 4.0)]))
        run_s = float(rng.choice([0.0, 600.0 * rng.randint(0, 5),
                                  rng.uniform(0, 4000)]))
        interval = float(rng.choice([0.0, -1.0, 600.0, 100.0, 7.0]))
        done_now = done0 + rate * run_s * float(rng.uniform(0.9, 1.0))
        args = (done0, done_now, rate, run_s, interval)
        assert tfaults.rollback_point(*args) == jfaults.rollback_point(*args)


def _running_jobs(mod_job, cluster_nodes, rng, n):
    """Jobs holding allocations on ``cluster_nodes`` (node -> {type: c})."""
    jobs = []
    free = {(h, r): c for h, g in cluster_nodes for r, c in g.items()}
    for j in range(n):
        tp = {r: float(rng.uniform(0.5, 3.0)) for r in TYPES}
        job = mod_job(j, 0.0, 1, 10, 100, tp)
        alloc = {}
        for k in sorted(free):
            if free[k] > 0 and rng.rand() < 0.3:
                take = int(rng.randint(1, free[k] + 1))
                alloc[k] = take
                free[k] -= take
        if alloc and len({r for _, r in alloc}) >= 1:
            job.alloc = alloc
            job.n_workers = sum(alloc.values())
            job.done_iters = float(rng.uniform(0, 900))
        jobs.append(job)
    return jobs


@pytest.mark.parametrize("seed", range(6))
def test_select_evictions_matches_jax_package(seed):
    nodes = [(i, {TYPES[i % 3]: 4, TYPES[(i + 2) % 3]: 2}) for i in range(6)]
    jjobs = _running_jobs(JJob, nodes, np.random.RandomState(seed), 10)
    tjobs = _running_jobs(Job, nodes, np.random.RandomState(seed), 10)
    rng = np.random.RandomState(100 + seed)
    full = {(h, r): c for h, g in nodes for r, c in g.items()}
    for _ in range(8):
        down = set(rng.choice(6, size=int(rng.randint(0, 4)), replace=False))
        cap = {k: (0 if k[0] in down else max(0, c - int(rng.randint(0, 2))))
               for k, c in full.items()}
        want = [j.job_id for j in jfaults.select_evictions(jjobs, cap)]
        got = [j.job_id for j in tfaults.select_evictions(tjobs, cap)]
        assert got == want


def test_fault_state_views_match_jax_package():
    """One view object per down-set (what keeps a persistent PriceState
    from being rebuilt at every consult), the same live counts and the
    same round-quantized advance as the reference."""
    jcl, tcl = _clusters("sim")
    tr = [(1, 100.0, 500.0), (12, 300.0, 900.0), (3, 300.0)]
    js = jfaults.FaultState(jfaults.FailureTrace(tr, jcl), jcl)
    ts = tfaults.FaultState(tfaults.FailureTrace(tr, tcl), tcl)
    assert ts.view() is tcl
    views = {}
    for t in (0.0, 100.0, 250.0, 300.0, 499.0, 500.0, 900.0, 1e6):
        assert ts.advance_to(t) == js.advance_to(t)
        assert ts.down == js.down
        assert ts.up_counts() == js.up_counts()
        assert ts.next_change(t) == js.next_change(t)
        assert ts.live_capacity() == js.live_capacity()
        assert [n.node_id for n in ts.view().nodes] == \
            [n.node_id for n in js.view().nodes]
        key = frozenset(ts.down)
        assert views.setdefault(key, ts.view()) is ts.view()
    assert ts.recover_time(12, 300.0) == 900.0
    assert math.isinf(ts.recover_time(3, 300.0))
    assert ts.active_window(12, 400.0) == tfaults.FaultWindow(12, 300.0,
                                                              900.0)


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------

def _job_rows(jobs):
    return [dataclasses.astuple(j) for j in jobs]


@pytest.mark.parametrize("types,hetero", [(TYPES, False), (TYPES, True),
                                          (None, False), (["v100"], True)])
def test_philly_mini_loads_as_jax_package(types, hetero):
    want = jreplay.load_trace_csv(str(MINI), types=types,
                                  hetero_restarts=hetero)
    got = treplay.load_trace_csv(str(MINI), types=types,
                                 hetero_restarts=hetero)
    assert _job_rows(got) == _job_rows(want) and len(got) == 12


def test_trace_csv_round_trips_across_packages(tmp_path):
    jobs = ttrace.philly_trace(n_jobs=25, seed=6, all_at_start=False,
                               hetero_restarts=True)
    treplay.save_trace_csv(jobs, str(tmp_path / "t.csv"))
    jreplay.save_trace_csv(jtrace.philly_trace(
        n_jobs=25, seed=6, all_at_start=False, hetero_restarts=True),
        str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()
    back = treplay.load_trace_csv(str(tmp_path / "t.csv"))
    assert _job_rows(back) == _job_rows(
        jreplay.load_trace_csv(str(tmp_path / "t.csv")))
    assert [(j.job_id, j.arrival, j.throughput, j.restart_penalty)
            for j in back] == [(j.job_id, j.arrival, j.throughput,
                                j.restart_penalty) for j in jobs]


def test_fault_csv_loads_and_round_trips_as_jax_package(tmp_path):
    jcl, tcl = _clusters("sim")
    want = jreplay.load_fault_csv(str(MINI_FAULTS), jcl)
    got = treplay.load_fault_csv(str(MINI_FAULTS), tcl)
    assert _windows(got) == _windows(want) and len(got) == 4
    treplay.save_fault_csv(got, str(tmp_path / "t.csv"))
    jreplay.save_fault_csv(want, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()
    assert treplay.load_fault_csv(str(tmp_path / "t.csv")) == got


BAD_JOB_ROWS = [
    "job_id,arrival,n_workers,model,duration_hours\n1,0,1,nosuchmodel,2\n",
    "job_id,arrival,n_workers,model\n1,0,1,resnet18\n",
    "job_id,arrival,n_workers,model,duration_hours\n7,0,1,resnet18,0.5\n"
    "7,10,1,lstm,1.0\n",
    "job_id,arrival,n_workers,duration_hours,tp_v100\n1,0,1,0.5,3.0\n",
    "job_id,arrival,n_workers,model,duration_hours\n1,yesterday,1,lstm,1\n",
]
BAD_FAULT_ROWS = [
    "node_id,fail_time\n,5.0\n",
    "node_id,fail_time\n0,\n",
    "node_id,fail_time,recover_time\n0,abc,5\n",
    "node_id,fail_time,recover_time\n0,1.0,5.0\n0,3.0,9.0\n",
    "node_id,fail_time,recover_time,kind\n0,1.0,5.0,quake\n",
    "node_id,fail_time,recover_time\n40,1.0,5.0\n",
]


@pytest.mark.parametrize("text", BAD_JOB_ROWS)
def test_trace_loader_rejects_what_the_jax_package_rejects(tmp_path, text):
    p = tmp_path / "bad.csv"
    p.write_text(text)
    with pytest.raises(ValueError) as want:
        jreplay.load_trace_csv(str(p), types=["v100", "p100"])
    with pytest.raises(ValueError) as got:
        treplay.load_trace_csv(str(p), types=["v100", "p100"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("text", BAD_FAULT_ROWS)
def test_fault_loader_rejects_what_the_jax_package_rejects(tmp_path, text):
    p = tmp_path / "bad.csv"
    p.write_text(text)
    jcl, tcl = _clusters("sim")
    with pytest.raises(ValueError) as want:
        jreplay.load_fault_csv(str(p), jcl)
    with pytest.raises(ValueError) as got:
        treplay.load_fault_csv(str(p), tcl)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Hadar (solver="numpy") through both engines, with and without faults
# ---------------------------------------------------------------------------

def _mini(pkg):
    """philly_mini on simulation_cluster() from ``pkg``'s replay."""
    cl = (jtrace if pkg is jreplay else ttrace).simulation_cluster()
    return pkg.load_trace_csv(str(MINI), types=TYPES), cl


MINI_MODEL = dict(seed=1, mtbf_hours=3.0, spot_frac=0.3,
                  spot_reclaim_hours=3.0, recovery_dist="exponential",
                  recovery_s=3600.0)
FAULTS = {
    "none": (None, None),
    "csv": (lambda: jreplay.load_fault_csv(str(MINI_FAULTS)),
            lambda: treplay.load_fault_csv(str(MINI_FAULTS))),
    "k80_outage": (lambda: jfaults.FailureTrace(K80_OUTAGE),
                   lambda: tfaults.FailureTrace(K80_OUTAGE)),
    "v100_outage": (lambda: jfaults.FailureTrace(V100_OUTAGE),
                    lambda: tfaults.FailureTrace(V100_OUTAGE)),
    "model": (lambda: jfaults.FailureModel(**MINI_MODEL),
              lambda: tfaults.FailureModel(**MINI_MODEL)),
}


def _faults(name):
    jf, tf = FAULTS[name]
    return (jf() if jf else None), (tf() if tf else None)


class _Types(HadarScheduler):
    """The port's Hadar, noting how many GPU types each consult's view
    has."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.types = []

    def schedule(self, now, round_len, jobs, cluster):
        self.types.append(len(cluster.gpu_types))
        return super().schedule(now, round_len, jobs, cluster)


@pytest.mark.parametrize("engine", ["simulate_events", "simulate_rounds"])
@pytest.mark.parametrize("faults", list(FAULTS))
def test_hadar_on_philly_mini_matches_jax_package(engine, faults):
    jf, tf = _faults(faults)
    jjobs, jcl = _mini(jreplay)
    tjobs, tcl = _mini(treplay)
    want = getattr(jengine, engine)(JHadar(solver="numpy"), jjobs, jcl,
                                    faults=jf)
    sched = _Types(solver="numpy")
    got = getattr(tengine, engine)(sched, tjobs, tcl, faults=tf)
    assert result_fields(got) == result_fields(want)
    assert all(j.finish_time is not None for j in got.jobs)
    assert (got.evictions > 0) == (faults in ("v100_outage", "model"))
    if faults != "model":                   # (the model's may, too)
        assert min(sched.types) == (2 if faults.endswith("outage") else 3)


@pytest.mark.parametrize("n,seed", [(8, 1), (12, 2), (16, 3), (16, 9)])
@pytest.mark.parametrize("engine", ["simulate_events", "simulate_rounds"])
def test_hadar_under_a_failure_model_matches_jax_package(n, seed, engine):
    kw = dict(seed=seed, mtbf_hours=10.0, spot_frac=0.25,
              spot_reclaim_hours=5.0, recovery_dist="exponential",
              checkpoint_interval=900.0)
    jcl, tcl = _clusters("sim")
    jjobs = jtrace.philly_trace(n_jobs=n, seed=seed, all_at_start=False,
                                hetero_restarts=True)
    tjobs = ttrace.philly_trace(n_jobs=n, seed=seed, all_at_start=False,
                                hetero_restarts=True)
    want = getattr(jengine, engine)(JHadar(solver="numpy"), jjobs, jcl,
                                    faults=jfaults.FailureModel(**kw))
    got = getattr(tengine, engine)(HadarScheduler(solver="numpy"), tjobs,
                                   tcl, faults=tfaults.FailureModel(**kw))
    assert result_fields(got) == result_fields(want)
    assert got.evictions > 0


@pytest.mark.parametrize("n", [6, 16])
def test_hadar_events_without_faults_match_jax_package(n):
    jcl, tcl = _clusters("grown")
    want = jengine.simulate_events(
        JHadar(solver="numpy"), jtrace.philly_trace(n_jobs=n, seed=1), jcl,
        round_len=120.0)
    got = tengine.simulate_events(
        HadarScheduler(solver="numpy"), ttrace.philly_trace(n_jobs=n, seed=1),
        tcl, round_len=120.0)
    assert result_fields(got) == result_fields(want)
    assert got.gpu_seconds_lost == 0.0 and got.goodput() == got.gru_overall()


def test_event_engine_rollback_and_never_fit_match_jax_package():
    """The one-node cases of the reference's fault tests (rollback to the
    last checkpoint, a failure at t=0, back-to-back windows, a completion
    at the failure instant) and a job no cluster can hold."""
    def jobs(mod, extra):
        out = [mod(0, 0.0, 1, 10, 100, {"v100": 1.0}, restart_penalty=10.0)]
        if extra:
            out.append(mod(1, 5.0, 3, 1, 10, {"v100": 1.0}))
        return out
    cases = [([(0, 250.0, 400.0)], 100.0, False),
             ([(0, 0.0, 50.0)], None, False),
             ([(0, 20.0, 40.0), (0, 40.0, 60.0)], None, False),
             ([(0, 1010.0, 1200.0)], None, False),
             ([(0, 1009.5, 1200.0)], None, True)]
    for faults, ckpt, extra in cases:
        want = jengine.simulate_events(
            JHadar(solver="numpy"), jobs(JJob, extra),
            JCluster([JNode(0, {"v100": 1})]), faults=faults,
            checkpoint_interval=ckpt)
        got = tengine.simulate_events(
            HadarScheduler(solver="numpy"), jobs(Job, extra),
            Cluster([Node(0, {"v100": 1})]), faults=faults,
            checkpoint_interval=ckpt)
        assert result_fields(got) == result_fields(want)
    assert got.jobs[1].finish_time is None      # never fits


def test_round_engine_fast_forward_stops_at_a_fault_as_jax_package():
    def run(eng, hadar, mod_job, cl):
        return eng.simulate_rounds(
            hadar, [mod_job(0, 0.0, 1, 50, 100, {"v100": 1.0},
                            restart_penalty=10.0)],
            cl, round_len=60.0, faults=[(0, 2400.0, 3000.0)])
    want = run(jengine, JHadar(solver="numpy"), JJob,
               JCluster([JNode(0, {"v100": 1})]))
    got = run(tengine, HadarScheduler(solver="numpy"), Job,
              Cluster([Node(0, {"v100": 1})]))
    assert result_fields(got) == result_fields(want)
    assert got.evictions == 1 and got.goodput() < got.gru_overall()


# ---------------------------------------------------------------------------
# event_stream driven by a policy written here
# ---------------------------------------------------------------------------

def _first_fit(cp):
    """Keep running jobs; place each waiting job, FIFO, on the first
    nodes with free devices of its fastest type in the view."""
    free = {(n.node_id, r): c for n in cp.view.nodes
            for r, c in sorted(n.gpus.items())}
    out = {}
    for j in cp.jobs:
        if j.alloc and not j.is_done():
            if all(free.get(k, 0) >= c for k, c in j.alloc.items()):
                out[j.job_id] = j.alloc
                for k, c in j.alloc.items():
                    free[k] -= c
    for j in cp.jobs:
        if j.is_done() or j.arrival > cp.t or j.job_id in out:
            continue
        for r in sorted(j.throughput, key=lambda r: -j.throughput[r]):
            keys = [k for k in sorted(free) if k[1] == r and free[k] > 0]
            if sum(free[k] for k in keys) < j.n_workers:
                continue
            need, alloc = j.n_workers, {}
            for k in keys:
                take = min(need, free[k])
                alloc[k] = take
                need -= take
                if need == 0:
                    break
            for k, c in alloc.items():
                free[k] -= c
            out[j.job_id] = alloc
            break
    return out


def _drive(stream):
    points = []
    send = None
    while True:
        try:
            cp = stream.send(send)
        except StopIteration as stop:
            return points, stop.value
        points.append((cp.t, cp.round_len, list(cp.completed), cp.queue_len,
                       sorted(cp.down), [n.node_id for n in cp.view.nodes],
                       cp.busy_gpu_seconds, cp.avail_gpu_seconds,
                       cp.lost_gpu_seconds, cp.evictions))
        desired = _first_fit(cp)
        send = (desired, 0.25) if len(points) % 2 else desired


@pytest.mark.parametrize("faults", ["none", "k80_outage", "v100_outage",
                                    "model"])
@pytest.mark.parametrize("stable", [False, True])
def test_event_stream_with_a_test_policy_matches_jax_package(faults,
                                                             stable):
    jf, tf = _faults(faults)
    jjobs, jcl = _mini(jreplay)
    tjobs, tcl = _mini(treplay)
    want = _drive(jengine.event_stream(jjobs, jcl, faults=jf, stable=stable,
                                       name="first-fit"))
    got = _drive(tengine.event_stream(tjobs, tcl, faults=tf, stable=stable,
                                      name="first-fit"))
    assert got[0] == want[0] and len(got[0]) > 5
    assert result_fields(got[1]) == result_fields(want[1])
    assert [r.sched_seconds for r in got[1].rounds] == \
        [r.sched_seconds for r in want[1].rounds]


# ---------------------------------------------------------------------------
# the batched path (the kernels' plain versions) under faults
# ---------------------------------------------------------------------------

def test_batched_hadar_equals_numpy_in_the_event_engine_under_faults(
        monkeypatch):
    """``solver="cuda", device="cpu"`` (K4/K5's plain versions) decides as
    ``numpy`` in the event engine, through windows that take the K80 or
    the V100 type out of the view (R = 2; the V100 one evicts) and the
    fault CSV."""
    calls = []
    real = tbs.find_alloc_batch

    def counted(jobs, *a, **kw):
        calls.append(len(jobs))
        return real(jobs, *a, **kw)
    monkeypatch.setattr(tbs, "find_alloc_batch", counted)
    for name in ("k80_outage", "v100_outage", "csv"):
        res = {}
        for solver in ("numpy", "cuda"):
            tjobs, tcl = _mini(treplay)
            res[solver] = tengine.simulate_events(
                HadarScheduler(solver=solver, device="cpu"), tjobs, tcl,
                faults=_faults(name)[1])
        assert result_fields(res["cuda"]) == result_fields(res["numpy"])
    assert res["cuda"].avg_jct() > 0 and calls

"""The port's HadarE (``repro_torch.core.hadare`` and
``repro_torch.sim.adapters``) against the JAX package's, on the CPU.

The same inputs, built from fixed seeds for both packages, go through
job forking, the Job Tracker, sibling dedupe, the vectorized
``simulate_hadare`` with and without faults (a model, the philly_mini
fault CSV, and a window that takes every K80 node of
``simulation_cluster()`` down at once), ``simulate_pods`` and the
``CountingScheduler``/``run`` adapters.  Hadar runs in both packages with
``solver="numpy"`` (the reference scheduler is built here and passed as
``scheduler=``); the port's batched path (``solver="cuda",
device="cpu"``: the kernels' plain versions) is held to its NumPy path
consult by consult, decision keys in order.  Results are compared in
every field but ``sched_seconds`` (host time).  Last, the port-side
counterparts of the reference's HadarE property tests that need no
training code.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from repro.core import hadare as jhadare
from repro.core import trace as jtrace
from repro.core.hadar import HadarScheduler as JHadar
from repro.core.types import Cluster as JCluster
from repro.core.types import Job as JJob
from repro.core.types import Node as JNode
from repro.sim import adapters as jadapters
from repro.sim import engine as jengine
from repro.sim import faults as jfaults
from repro.sim import replay as jreplay
from repro_torch.core import batch_solver as tbs
from repro_torch.core import hadare as thadare
from repro_torch.core import trace as ttrace
from repro_torch.core.hadar import HadarScheduler
from repro_torch.core.simulator import simulate
from repro_torch.core.types import Cluster, Job, Node
from repro_torch.sim import adapters as tadapters
from repro_torch.sim import engine as tengine
from repro_torch.sim import faults as tfaults
from repro_torch.sim import replay as treplay
from repro_torch.sim.metrics import result_fields

REPO = Path(__file__).resolve().parent.parent
MINI = REPO / "examples" / "traces" / "philly_mini.csv"
MINI_FAULTS = REPO / "examples" / "traces" / "philly_mini_faults.csv"
TYPES = ["v100", "p100", "k80"]
# the smoke's failure model
FAULT_MODEL = dict(seed=7, mtbf_hours=72.0, spot_frac=0.2,
                   spot_reclaim_hours=24.0)
# every K80 node of simulation_cluster() (nodes 10-14) down together
K80_OUTAGE = [(n, 7200.0, 40000.0, "fail") for n in range(10, 15)]
# every P100 node (5-9) down while philly_mini's first copies run there
P100_OUTAGE = [(n, 300.0, 20000.0, "fail") for n in range(5, 10)]
MIXES = ["M-1", "M-3", "M-4", "M-5", "M-8", "M-10", "M-12"]
# the two packages' modules, in the order (reference, port)
PKGS = {"trace": (jtrace, ttrace), "job": (JJob, Job),
        "node": (JNode, Node), "cluster": (JCluster, Cluster),
        "faults": (jfaults, tfaults), "replay": (jreplay, treplay),
        "adapters": (jadapters, tadapters), "hadare": (jhadare, thadare),
        "engine": (jengine, tengine)}


def _pkg(side):
    """The modules of one side: 0 the JAX package, 1 the port."""
    return {k: v[side] for k, v in PKGS.items()}


def _hadar(side, **kw):
    return (JHadar if side == 0 else HadarScheduler)(solver="numpy", **kw)


def _both(build):
    """``build(modules, side)`` for the reference and for the port."""
    return build(_pkg(0), 0), build(_pkg(1), 1)


def _assert_same(build):
    want, got = _both(build)
    assert result_fields(got) == result_fields(want)
    return got


# ---------------------------------------------------------------------------
# forking, the Job Tracker and sibling dedupe
# ---------------------------------------------------------------------------

def _copy_rows(copies):
    return [dataclasses.astuple(c) for c in copies]


@pytest.mark.parametrize("job_id,n_copies", [(0, 1), (7, 3), (9999, 5),
                                             (42, 15)])
def test_fork_job_matches_jax_package(job_id, n_copies):
    def build(m, side):
        j = m["job"](job_id, 30.0, 2, 10, 10, {"t4": 1.0, "k80": 0.4},
                     model="lstm", restart_penalty=12.0)
        j.alloc = {(0, "t4"): 2}
        j.done_iters = 3.0
        return j, m["hadare"].fork_job(j, n_copies)
    (jj, want), (tj, got) = _both(build)
    assert _copy_rows(got) == _copy_rows(want)
    assert [c.job_id for c in got] == [thadare.MAX_JOB_COUNT * i + job_id
                                       for i in range(1, n_copies + 1)]
    assert all(c.parent == job_id and c.single_node and c.alloc is None
               for c in got)
    assert tj.alloc == {(0, "t4"): 2} and not tj.single_node
    assert thadare.MAX_JOB_COUNT == jhadare.MAX_JOB_COUNT


def _tracker_case(m, seed, n_nodes, early):
    """A tracker over four parents with seeded per-copy progress and
    rates; ``early``: parent 0's copies finish it exactly, mid-round."""
    rng = np.random.RandomState(seed)
    tr = m["hadare"].JobTracker(n_nodes=n_nodes)
    parents = [m["job"](i, 0.0, 1, 2 + i, 10, {"v100": 1.0, "k80": 0.3})
               for i in range(4)]
    copies = {p.job_id: tr.register(p) for p in parents}
    prog, rates = {}, {}
    for pid, cs in copies.items():
        for c in cs:
            prog[c.job_id] = float(rng.uniform(0.0, 6.0))
            rates[c.job_id] = float(rng.uniform(0.1, 2.0))
    if early:
        for c in copies[0]:
            prog[c.job_id] = parents[0].total_iters / n_nodes
    fin = tr.aggregate_round(prog, now_start=90.0, round_len=60.0,
                             rates=rates)
    nodes = ["v100", "k80"]
    for pid, cs in copies.items():
        for i, c in enumerate(cs):
            if not parents[pid].is_done() and rng.rand() < 0.7:
                c.alloc = {(i, nodes[i % 2]): 1}
    tr.split_remaining()
    again = tr.aggregate_round(prog, now_start=150.0, round_len=60.0)
    return (fin, again,
            [(p.done_iters, p.finish_time) for p in parents],
            [(c.job_id, c.done_iters, c.alloc, c.quota)
             for cs in copies.values() for c in cs],
            [tj.live_copies() == [] for tj in tr.tracked.values()])


@pytest.mark.parametrize("seed,n_nodes,early", [(0, 3, False), (1, 3, True),
                                                (2, 5, True), (3, 2, False)])
def test_job_tracker_matches_jax_package(seed, n_nodes, early):
    want, got = _both(lambda m, side: _tracker_case(m, seed, n_nodes, early))
    assert got == want
    if early:
        # parent 0 needed total/n from each of n copies: it is done at
        # 90 + need / (the copies' summed rate), inside the round
        assert 0 in got[0] and got[2][0][1] <= 150.0


def test_tracker_exact_early_finish():
    """20 iterations over three copies at 1 it/s each: 90 + 20/3."""
    j = Job(1, 0.0, 1, 2, 10, {"t4": 1.0})
    tr = thadare.JobTracker(n_nodes=3)
    copies = tr.register(j)
    prog = dict(zip((c.job_id for c in copies), (8.0, 8.0, 5.0)))
    fin = tr.aggregate_round(prog, now_start=90.0, round_len=10.0,
                             rates={c.job_id: 1.0 for c in copies})
    assert fin == [1]
    assert abs(j.finish_time - (90.0 + 20.0 / 3.0)) < 1e-9
    assert all(c.done_iters == j.done_iters and c.alloc is None
               for c in copies)


def _desired_case(m, seed, ties):
    """Three parents forked over 4 nodes and a seeded ``desired`` over
    their copies; ``ties``: every copy of a parent asks for the same
    node's same type, so their rates tie and dict order decides."""
    rng = np.random.RandomState(seed)
    tp = {"v100": 1.0, "p100": 0.6, "k80": 0.2}
    parents = [m["job"](i, 0.0, 1, 10, 10, dict(tp)) for i in range(3)]
    copies = [c for p in parents for c in m["hadare"].fork_job(p, 4)]
    by_id = {c.job_id: c for c in copies}
    types = list(tp)
    desired = {}
    for c in rng.permutation(len(copies)):
        cid = copies[c].job_id
        if rng.rand() < 0.15:
            desired[cid] = None
        elif ties:
            desired[cid] = {(int(cid % 2), "p100"): 1}
        else:
            desired[cid] = {(int(rng.randint(0, 4)),
                             types[rng.randint(0, 3)]): 1}
    return list(m["hadare"]._dedupe_siblings(desired, copies,
                                             by_id).items())


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True),
                                       (3, True)])
def test_dedupe_siblings_matches_jax_package(seed, ties):
    want, got = _both(lambda m, side: _desired_case(m, seed, ties))
    assert got == want and got
    seen = set()
    for cid, alloc in got:
        for node, _ in alloc:
            assert (cid % thadare.MAX_JOB_COUNT, node) not in seen
            seen.add((cid % thadare.MAX_JOB_COUNT, node))


def test_dedupe_keeps_the_faster_copy():
    tp = {"v100": 1.0, "k80": 0.1}
    fast, slow = thadare.fork_job(Job(3, 0.0, 1, 10, 10, tp), 2)
    by_id = {c.job_id: c for c in (fast, slow)}
    out = thadare._dedupe_siblings({slow.job_id: {(0, "k80"): 1},
                                    fast.job_id: {(0, "v100"): 1}},
                                   [fast, slow], by_id)
    assert list(out) == [fast.job_id]
    out2 = thadare._dedupe_siblings({fast.job_id: {(0, "v100"): 1},
                                     slow.job_id: {(1, "k80"): 1}},
                                    [fast, slow], by_id)
    assert list(out2) == [fast.job_id, slow.job_id]


# ---------------------------------------------------------------------------
# simulate_hadare, port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cluster", ["aws_cluster", "testbed_cluster"])
@pytest.mark.parametrize("mix", MIXES)
def test_hadare_mixes_match_jax_package(mix, cluster):
    def build(m, side):
        cl = getattr(m["trace"], cluster)()
        return m["adapters"].simulate_hadare(
            m["trace"].mix_jobs(mix, cl), cl, round_len=90.0,
            scheduler=_hadar(side))
    got = _assert_same(build)
    assert all(p.finish_time is not None for p in got.jobs)


@pytest.mark.parametrize("faulted", [False, True])
def test_hadare_philly16_matches_jax_package(faulted):
    def build(m, side):
        cl = m["trace"].simulation_cluster()
        return m["adapters"].simulate_hadare(
            m["trace"].philly_trace(16, seed=1, types=cl.gpu_types), cl,
            scheduler=_hadar(side),
            faults=(m["faults"].FailureModel(**FAULT_MODEL) if faulted
                    else None))
    got = _assert_same(build)
    assert got.evictions == (1 if faulted else 0)
    # two parents' gangs exceed every node: they never finish
    assert sum(p.finish_time is None for p in got.jobs) == 2


def _mini_faults(m, name, cl):
    if name == "csv":
        return m["replay"].load_fault_csv(str(MINI_FAULTS), cl)
    return m["faults"].FailureTrace(K80_OUTAGE if name == "k80_outage"
                                    else P100_OUTAGE)


@pytest.mark.parametrize("faults", ["csv", "k80_outage", "p100_outage"])
def test_hadare_philly_mini_under_faults_matches_jax_package(faults):
    def build(m, side):
        cl = m["trace"].simulation_cluster()
        return m["adapters"].simulate_hadare(
            m["replay"].load_trace_csv(str(MINI), types=TYPES), cl,
            scheduler=_hadar(side), faults=_mini_faults(m, faults, cl))
    got = _assert_same(build)
    # the philly_mini copies hold no K80 node or no CSV node when it
    # fails; every P100 node down at 300 s evicts the copies there
    assert got.evictions == (5 if faults == "p100_outage" else 0)


@pytest.mark.parametrize("mix,n_copies", [("M-1", 2), ("M-4", 2),
                                          ("M-1", 7), ("M-4", 7)])
def test_hadare_copy_counts_match_jax_package(mix, n_copies):
    """n_copies = 7 on the 5-node testbed: two copies of each parent more
    than nodes, so dedupe and capacity leave surplus copies idle."""
    def build(m, side):
        cl = m["trace"].testbed_cluster()
        return m["adapters"].simulate_hadare(
            m["trace"].mix_jobs(mix, cl), cl, round_len=90.0,
            n_copies=n_copies, scheduler=_hadar(side))
    _assert_same(build)


@pytest.mark.parametrize("mix", ["M-1", "M-4"])
def test_hadare_fast_forward_matches_jax_package(mix):
    """``fast_forward=False`` in both packages, and the port's fast
    forward equal to its round-by-round run in every field."""
    def run(m, side, ff, calls):
        class Counting(_hadar(side).__class__):
            def schedule(self, *a, **kw):
                calls.append(1)
                return super().schedule(*a, **kw)
        cl = m["trace"].testbed_cluster()
        return m["adapters"].simulate_hadare(
            m["trace"].mix_jobs(mix, cl), cl, round_len=30.0,
            scheduler=Counting(solver="numpy"), fast_forward=ff)
    slow_calls, fast_calls = [], []
    _assert_same(lambda m, side: run(m, side, False, []))
    slow = run(_pkg(1), 1, False, slow_calls)
    fast = run(_pkg(1), 1, True, fast_calls)
    assert result_fields(fast) == result_fields(slow)
    assert len(fast_calls) < len(slow_calls) == len(slow.rounds)


def test_hadare_hetero_restarts_match_jax_package():
    def build(m, side):
        cl = m["trace"].testbed_cluster()
        jobs = m["trace"].mix_jobs("M-4", cl, hetero_restarts=True)
        return m["adapters"].simulate_hadare(jobs, cl, round_len=90.0,
                                             scheduler=_hadar(side))
    got = _assert_same(build)
    assert len({p.restart_penalty for p in got.jobs}) > 1


def test_hadare_late_arrivals_and_core_entry_match_jax_package():
    """Parents arriving mid-run register at the next round boundary; the
    core module's ``simulate_hadare`` is the adapters' backend."""
    def build(m, side, entry):
        tp = {"v100": 1.0, "p100": 0.6, "k80": 0.2}
        jobs = [m["job"](0, 0.0, 1, 20, 10, dict(tp)),
                m["job"](1, 250.0, 1, 10, 10, dict(tp)),
                m["job"](2, 910.0, 1, 8, 10, dict(tp))]
        cl = m["cluster"]([m["node"](0, {"v100": 1}),
                           m["node"](1, {"p100": 1}),
                           m["node"](2, {"k80": 1})])
        return m[entry].simulate_hadare(jobs, cl, round_len=100.0,
                                        scheduler=_hadar(side))
    got = _assert_same(lambda m, side: build(m, side, "hadare"))
    assert result_fields(build(_pkg(1), 1, "adapters")) == \
        result_fields(got)
    assert got.rounds[0].running + got.rounds[0].waiting == 1
    late = got.jobs[1]
    assert late.finish_time >= 300.0


def test_hadare_early_finish_is_exact():
    cluster = Cluster([Node(0, {"v100": 1}), Node(1, {"p100": 1})])
    res = tadapters.simulate_hadare(
        [Job(0, 0.0, 1, 15, 10, {"v100": 1.0, "p100": 0.5})], cluster,
        round_len=100.0, sync_overhead=5.0, restart_penalty=10.0,
        scheduler=HadarScheduler(solver="numpy"))
    # round 0: 85 effective s at 1.5 it/s = 127.5; 22.5 left -> 15 s in
    assert res.jobs[0].finish_time == pytest.approx(115.0, abs=1e-9)


def test_hadare_total_outage_matches_jax_package():
    """Every node down for a while: the view has no nodes, the consult is
    skipped (``desired = {}``) and every copy is evicted."""
    def build(m, side):
        cl = m["trace"].testbed_cluster()
        wins = [(n.node_id, 100.0, 650.0) for n in cl.nodes]
        return m["adapters"].simulate_hadare(
            m["trace"].mix_jobs("M-4", cl), cl, round_len=90.0,
            scheduler=_hadar(side), faults=m["faults"].FailureTrace(wins))
    got = _assert_same(build)
    assert got.evictions == 5 and got.gpu_seconds_lost > 0.0
    assert any(r.cru == 0.0 and r.sched_seconds == 0.0 for r in got.rounds)


# ---------------------------------------------------------------------------
# simulate_pods, CountingScheduler and run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["event", "round"])
def test_simulate_pods_match_jax_package(mode):
    """Four of pod 0's nodes down from 1000 s: pod 0 evicts, pods 1-2
    are those of the run without it, and each pod equals the
    reference's."""
    def build(m, side, outage):
        cl = m["trace"].multi_cluster(n_pods=3)
        wins = ([m["faults"].FaultWindow(n, 1000.0, 20000.0)
                 for n in cl.pods[0][:4]] if outage else [])
        return m["adapters"].simulate_pods(
            lambda: _hadar(side), m["trace"].philly_trace(n_jobs=12, seed=3),
            cl, mode=mode,
            faults=m["faults"].FailureTrace(wins, cl) if outage else None)
    for outage in (True, False):
        want, got = _both(lambda m, side: build(m, side, outage))
        assert [result_fields(r) for r in got] == \
            [result_fields(r) for r in want]
        if outage:
            faulty = got
    clean = got
    assert faulty[0].evictions >= 1
    assert faulty[0].goodput() < faulty[0].gru_overall()
    for p in (1, 2):
        assert result_fields(faulty[p]) == result_fields(clean[p])


def test_simulate_pods_assign_and_model_match_jax_package():
    def build(m, side):
        cl = m["trace"].multi_cluster(n_pods=3)
        jobs = m["trace"].philly_trace(n_jobs=9, seed=5)
        assign = {j.job_id: (j.job_id * 7) % 3 for j in jobs}
        return m["adapters"].simulate_pods(
            lambda: _hadar(side), jobs, cl, mode="round", assign=assign,
            faults=m["faults"].FailureModel(seed=2, mtbf_hours=6.0))
    want, got = _both(build)
    assert [result_fields(r) for r in got] == \
        [result_fields(r) for r in want]


def test_simulate_pods_requires_pod_topology():
    with pytest.raises(ValueError, match="pod topology"):
        tadapters.simulate_pods(HadarScheduler, ttrace.philly_trace(4),
                                ttrace.simulation_cluster())


@pytest.mark.parametrize("mode", ["round", "event"])
def test_counting_scheduler_and_run_match_jax_package(mode):
    def build(m, side):
        cl = m["trace"].simulation_cluster()
        sched = m["adapters"].CountingScheduler(_hadar(side))
        res = m["adapters"].run(sched, m["trace"].philly_trace(
            8, seed=2, types=cl.gpu_types), cl, mode=mode)
        return sched, res
    (js, want), (ts, got) = _both(build)
    assert result_fields(got) == result_fields(want)
    assert ts.calls == js.calls > 0 and ts.total_seconds > 0.0
    assert (ts.name, ts.preemptive, ts.stable_when_idle, ts.solver) == \
        (js.name, js.preemptive, js.stable_when_idle, js.solver)
    eng = tengine.simulate_rounds if mode == "round" else \
        tengine.simulate_events
    cl = ttrace.simulation_cluster()
    plain = eng(HadarScheduler(solver="numpy"),
                ttrace.philly_trace(8, seed=2, types=cl.gpu_types), cl)
    assert result_fields(plain) == result_fields(got)


def test_counting_scheduler_delegates():
    class Plain(tadapters.Scheduler):
        name = "plain"

        def schedule(self, now, round_len, jobs, cluster):
            return {}
    inner = HadarScheduler(solver="numpy")
    cs = tadapters.CountingScheduler(inner)
    cs.solver = "cuda"
    assert inner.solver == "cuda" and cs.solver == "cuda"
    cs.note_completion()
    assert inner._had_completion
    other = tadapters.CountingScheduler(Plain())
    other.solver = "numpy"
    other.note_completion()
    assert other.solver is None and not hasattr(other.inner, "solver")
    assert other.schedule(0.0, 1.0, [], None) == {} and other.calls == 1
    with pytest.raises(ValueError, match="unknown engine mode"):
        tadapters.run(inner, [], ttrace.simulation_cluster(), mode="bogus")
    with pytest.raises(ValueError):
        tadapters.simulate_hadare([], ttrace.simulation_cluster(),
                                  solver="jax")


# ---------------------------------------------------------------------------
# the batched path (the kernels' plain versions), consult by consult
# ---------------------------------------------------------------------------

def _keyed_run(m, sched, build, monkeypatch):
    """Run ``build(sched)`` noting each consult's decision keys in order,
    before and after sibling dedupe."""
    raw, kept = [], []
    real_schedule = sched.schedule
    real_dedupe = m["hadare"]._dedupe_siblings

    def schedule(*a):
        out = real_schedule(*a)
        raw.append(list(out))
        return out

    def dedupe(*a):
        out = real_dedupe(*a)
        kept.append(list(out))
        return out
    sched.schedule = schedule
    monkeypatch.setattr(m["hadare"], "_dedupe_siblings", dedupe)
    res = build(sched)
    monkeypatch.setattr(m["hadare"], "_dedupe_siblings", real_dedupe)
    return res, raw, kept


@pytest.mark.parametrize("case", ["model", "k80_outage"])
def test_batched_hadare_equals_numpy_consult_by_consult(case, monkeypatch):
    """``solver="cuda", device="cpu"`` decides as ``numpy`` in
    ``simulate_hadare`` under faults, with the same decision keys in the
    same order at every consult, and both as the JAX package."""
    calls = []
    real = tbs.find_alloc_batch

    def counted(jobs, *a, **kw):
        calls.append(len(jobs))
        return real(jobs, *a, **kw)
    monkeypatch.setattr(tbs, "find_alloc_batch", counted)

    def build(m):
        def go(sched):
            cl = m["trace"].simulation_cluster()
            if case == "model":
                jobs = m["trace"].philly_trace(16, seed=1,
                                               types=cl.gpu_types)
                faults = m["faults"].FailureModel(**FAULT_MODEL)
            else:
                jobs = m["replay"].load_trace_csv(str(MINI), types=TYPES)
                faults = m["faults"].FailureTrace(K80_OUTAGE)
            return m["adapters"].simulate_hadare(jobs, cl, scheduler=sched,
                                                 faults=faults)
        return go
    runs = {}
    for solver in ("numpy", "cuda"):
        runs[solver] = _keyed_run(
            _pkg(1), HadarScheduler(solver=solver, device="cpu"),
            build(_pkg(1)), monkeypatch)
    runs["jax"] = _keyed_run(_pkg(0), JHadar(solver="numpy"),
                             build(_pkg(0)), monkeypatch)
    want = runs["numpy"]
    for name in ("cuda", "jax"):
        res, raw, kept = runs[name]
        assert result_fields(res) == result_fields(want[0]), name
        assert raw == want[1] and kept == want[2], name
    assert max(calls) > 24 and len(want[1]) > 10
    assert any(len(r) > len(k) for r, k in zip(want[1], want[2]))


# ---------------------------------------------------------------------------
# the reference's HadarE properties, on the port
# ---------------------------------------------------------------------------

def _mixes(mix, **kw):
    cluster = ttrace.testbed_cluster()
    return ttrace.mix_jobs(mix, cluster, **kw), cluster


def test_hadare_no_idle_nodes_corollary():
    jobs, cluster = _mixes("M-3")
    res = thadare.simulate_hadare(jobs, cluster, round_len=90.0,
                                  scheduler=HadarScheduler(solver="numpy"))
    for r in res.rounds[:-1]:
        assert r.cru == 1.0, f"idle node at t={r.t}"


@pytest.mark.parametrize("mix", ["M-1", "M-4"])
def test_hadare_not_slower_than_hadar(mix):
    jobs, cluster = _mixes(mix)
    res_e = thadare.simulate_hadare(jobs, cluster, round_len=90.0,
                                    scheduler=HadarScheduler(solver="numpy"))
    res_h = simulate(HadarScheduler(solver="numpy"), _mixes(mix)[0],
                     cluster, round_len=90.0)
    assert res_e.total_seconds <= res_h.total_seconds
    assert res_e.avg_cru() >= res_h.avg_cru()


def test_thm3_cru_monotone_in_copies():
    cluster = ttrace.testbed_cluster()
    n = len(cluster.nodes)
    crus = {}
    for x in (1, 2, n, n + 2):
        res = thadare.simulate_hadare(
            ttrace.mix_jobs("M-1", cluster), cluster, round_len=90.0,
            n_copies=x, scheduler=HadarScheduler(solver="numpy"))
        crus[x] = res.avg_cru()
    assert crus[1] <= crus[2] + 1e-9
    assert crus[2] <= crus[n] + 1e-9
    assert abs(crus[n] - crus[n + 2]) < 1e-9


def _multi_gpu(n, w):
    cluster = Cluster([Node(0, {"v100": 4}), Node(1, {"p100": 4}),
                       Node(2, {"k80": 4})])
    tp = {"v100": 1.0, "p100": 0.6, "k80": 0.2}
    return [Job(i, 0.0, w, epochs=20, iters_per_epoch=10,
                throughput=dict(tp)) for i in range(n)], cluster


def test_copies_single_node_and_distinct(monkeypatch):
    kept = []
    real = thadare._dedupe_siblings

    def dedupe(desired, copies, by_id):
        out = real(desired, copies, by_id)
        kept.append([(by_id[c].parent, by_id[c].single_node, a)
                     for c, a in out.items()])
        return out
    monkeypatch.setattr(thadare, "_dedupe_siblings", dedupe)
    jobs, cluster = _multi_gpu(2, 2)
    res = thadare.simulate_hadare(jobs, cluster, round_len=60.0,
                                  max_rounds=500,
                                  scheduler=HadarScheduler(solver="numpy"))
    assert all(p.finish_time is not None for p in res.jobs)
    assert all(r.gru <= 1.0 + 1e-9 for r in res.rounds)
    assert kept
    for consult in kept:
        seen = set()
        for parent, single, alloc in consult:
            nodes = {n for n, _ in alloc}
            assert single and len(nodes) == 1
            assert (parent, *nodes) not in seen
            seen.add((parent, *nodes))


def test_w2_hadare_not_slower_than_hadar():
    jobs, cluster = _multi_gpu(2, 2)
    res_e = thadare.simulate_hadare(jobs, cluster, round_len=60.0,
                                    max_rounds=500,
                                    scheduler=HadarScheduler(solver="numpy"))
    res_h = simulate(HadarScheduler(solver="numpy"), _multi_gpu(2, 2)[0],
                     cluster, round_len=60.0, max_rounds=500)
    assert res_e.total_seconds <= res_h.total_seconds * 1.05
    assert res_e.avg_cru() >= res_h.avg_cru() - 1e-9


def test_progress_conservation_w2():
    jobs, cluster = _multi_gpu(1, 2)
    total = jobs[0].total_iters
    res = thadare.simulate_hadare(jobs, cluster, round_len=60.0,
                                  max_rounds=500,
                                  scheduler=HadarScheduler(solver="numpy"))
    p = res.jobs[0]
    assert p.done_iters == pytest.approx(total)
    assert total <= 3 * 2 * 1.0 * p.finish_time + 1e-6

"""The port's runtime sanitizer (``repro_torch.analysis.invariants`` and
its hooks) against the JAX package's, on the CPU.

Each ``check_*`` on the same inputs raises in both packages with the same
invariant, or passes in both; the reference's planted faults raise the
same invariant through the port's hooked entry points (``PriceState``,
``dp_allocation``, both engines, the env, HadarE); the port's own hooks on
its batched solver (K4's candidates, K5's carried free vector) fire on a
planted fault; and sanitized runs are bitwise equal to unsanitized ones.
"""
import types

import numpy as np
import pytest

from repro.analysis import invariants as jinv
from repro.core import dp as jdp
from repro.core import trace as jtrace
from repro.core.hadar import HadarScheduler as JHadar
from repro.core.pricing import PriceState as JPriceState
from repro.core.types import Cluster as JCluster
from repro.core.types import Job as JJob
from repro.core.types import Node as JNode
from repro.core.utility import effective_throughput as j_util
from repro.env import env as jenv
from repro.sim import adapters as jadapters
from repro.sim import engine as jengine
from repro.sim import faults as jfaults
from repro.sim.events import EventQueue as JEventQueue
from repro.sim.metrics import MetricsRecorder as JRecorder
from repro_torch.analysis import invariants as tinv
from repro_torch.core import batch_solver as tbs
from repro_torch.core import dp as tdp
from repro_torch.core import trace as ttrace
from repro_torch.core.hadar import HadarScheduler
from repro_torch.core.pricing import PriceState
from repro_torch.core.schedulers import GavelScheduler
from repro_torch.core.types import Cluster, Job, Node, clone_jobs
from repro_torch.core.utility import effective_throughput
from repro_torch.env import env as tenv
from repro_torch.kernels import ops
from repro_torch.sim import adapters as tadapters
from repro_torch.sim import engine as tengine
from repro_torch.sim import faults as tfaults
from repro_torch.sim.events import EventQueue
from repro_torch.sim.metrics import MetricsRecorder, result_fields

NS = types.SimpleNamespace


def _outcome(fn):
    """The invariant ``fn`` trips, or None when it passes."""
    try:
        fn()
    except jinv.InvariantViolation as e:
        return ("ref", e.invariant, dict(e.snapshot))
    except tinv.InvariantViolation as e:
        return ("port", e.invariant, dict(e.snapshot))
    return None


def _same(call):
    """``call(invariants_module)`` in both packages: the same outcome."""
    want, got = _outcome(lambda: call(jinv)), _outcome(lambda: call(tinv))
    assert (got is None) == (want is None), (got, want)
    if got is not None:
        assert got[0] == "port" and want[0] == "ref"
        assert got[1:] == want[1:]
    return got


def _ps(free, cap, gamma, umin=(1.0,), umax=(2.0,), conserved=True):
    n = len(free)
    return NS(free_arr=np.array(free, float), cap_arr=np.array(cap, float),
              gamma_arr=np.array(gamma, float),
              umin_arr=np.resize(np.array(umin, float), n),
              umax_arr=np.resize(np.array(umax, float), n),
              keys=[(i, "v100") for i in range(n)],
              key_index={(i, "v100"): i for i in range(n)},
              _conserved=conserved)


def _job(jid, alloc, n_workers=2, done=0.0, total=10.0):
    return NS(job_id=jid, alloc=alloc, n_workers=n_workers,
              done_iters=done, total_iters=total)


CHECKS = {
    "price_state_ok": lambda m: m.check_price_state(
        _ps([1, 2], [2, 2], [1, 0])),
    "price_state_free_below": lambda m: m.check_price_state(
        _ps([-1, 2], [2, 2], [3, 0])),
    "price_state_free_above": lambda m: m.check_price_state(
        _ps([3, 2], [2, 2], [0, 0])),
    "price_state_gamma_negative": lambda m: m.check_price_state(
        _ps([2, 2], [2, 2], [-1, 0])),
    "price_state_not_conserved": lambda m: m.check_price_state(
        _ps([2, 2], [2, 2], [1, 0])),
    "price_state_unconserved_ok": lambda m: m.check_price_state(
        _ps([2, 2], [2, 2], [1, 0], conserved=False)),
    "price_state_umin": lambda m: m.check_price_state(
        _ps([2], [2], [0], umin=(0.0,))),
    "price_state_umax": lambda m: m.check_price_state(
        _ps([2], [2], [0], umin=(3.0,), umax=(2.0,))),
    "commit_negative": lambda m: m.check_commit_amounts(
        _ps([2], [2], [0]), {(0, "v100"): -1}, "commit"),
    "commit_unknown_key": lambda m: m.check_commit_amounts(
        _ps([2], [2], [0]), {(9, "k80"): 1}, "release"),
    "commit_ok": lambda m: m.check_commit_amounts(
        _ps([2], [2], [0]), {(0, "v100"): 1}, "commit"),
    "candidate_ok": lambda m: m.check_candidate(
        7, 2, {(0, "v100"): 2}, 1.0, 0.5),
    "candidate_zero_count": lambda m: m.check_candidate(
        7, 2, {(0, "v100"): 2, (1, "v100"): 0}, 1.0, 0.5),
    "candidate_partial": lambda m: m.check_candidate(
        7, 4, {(0, "v100"): 3}, 1.0, 0.5),
    "candidate_negative_cost": lambda m: m.check_candidate(
        7, 2, {(0, "v100"): 2}, 1.0, -0.5),
    "candidate_payoff": lambda m: m.check_candidate(
        7, 2, {(0, "v100"): 2}, 0.0, 0.5),
    "candidate_payoff_forced": lambda m: m.check_candidate(
        7, 2, {(0, "v100"): 2}, 0.0, 0.5, forced=True),
    "selection_ok": lambda m: m.check_selection(
        {1: NS(alloc={(0, "v100"): 1}), 2: NS(alloc={(0, "v100"): 1})},
        {(0, "v100"): 2.0}),
    "selection_over": lambda m: m.check_selection(
        {1: NS(alloc={(0, "v100"): 2}), 2: NS(alloc={(0, "v100"): 1})},
        {(0, "v100"): 2.0}),
    "cluster_ok": lambda m: m.check_cluster_allocs(
        [_job(1, {(0, "v100"): 2}), _job(2, None)], {(0, "v100"): 2},
        0.0, "test"),
    "cluster_over": lambda m: m.check_cluster_allocs(
        [_job(1, {(0, "v100"): 4}, 4)], {(0, "v100"): 2}, 0.0, "test"),
    "cluster_partial": lambda m: m.check_cluster_allocs(
        [_job(1, {(0, "v100"): 1})], {(0, "v100"): 2}, 0.0, "test"),
    "cluster_zero": lambda m: m.check_cluster_allocs(
        [_job(1, {(0, "v100"): 0}, 0)], {(0, "v100"): 2}, 0.0, "test"),
    "progress_ok": lambda m: m.check_progress(
        _job(1, None, done=5.0), 1.0, "test", 4.0),
    "progress_over": lambda m: m.check_progress(
        _job(1, None, done=11.0), 1.0, "test"),
    "progress_back": lambda m: m.check_progress(
        _job(1, None, done=3.0), 1.0, "test", 4.0),
    "utilization_ok": lambda m: m.check_utilization(0.5, 1.0, 0.0, "t"),
    "utilization_gru": lambda m: m.check_utilization(1.5, 0.2, 0.0, "t"),
    "utilization_cru": lambda m: m.check_utilization(0.5, -0.2, 0.0, "t"),
    "monotonic_ok": lambda m: m.check_monotonic(2.0, 2.0, "t"),
    "monotonic_back": lambda m: m.check_monotonic(1.0, 2.0, "t"),
    "down_ok": lambda m: m.check_down_allocs(
        [_job(1, {(0, "v100"): 2})], {1}, 0.0, "t"),
    "down_hit": lambda m: m.check_down_allocs(
        [_job(1, {(0, "v100"): 2})], {0}, 0.0, "t"),
    "goodput_ok": lambda m: m.check_goodput(0.4, 0.5, "t"),
    "goodput_negative": lambda m: m.check_goodput(-0.1, 0.5, "t"),
    "goodput_over": lambda m: m.check_goodput(0.6, 0.5, "t"),
    "siblings_ok": lambda m: m.check_sibling_nodes(
        3, [_job(1, {(0, "v100"): 1}), _job(2, {(1, "v100"): 1})], 0.0),
    "siblings_shared": lambda m: m.check_sibling_nodes(
        3, [_job(1, {(0, "v100"): 1}), _job(2, {(0, "k80"): 1})], 0.0),
}


@pytest.mark.parametrize("case", list(CHECKS))
def test_check_matches_jax_package(case):
    got = _same(CHECKS[case])
    assert (got is None) == case.endswith(("_ok", "_forced"))


def test_flag_resolution_and_violation_match_jax_package(monkeypatch):
    assert tinv.ENV_FLAG == jinv.ENV_FLAG == "REPRO_SANITIZE"
    for value in (None, "1", "true", " Yes ", "on", "0", "no", ""):
        if value is None:
            monkeypatch.delenv("REPRO_SANITIZE", raising=False)
        else:
            monkeypatch.setenv("REPRO_SANITIZE", value)
        for flag in (None, True, False):
            assert tinv.sanitize_enabled(flag) == jinv.sanitize_enabled(flag)
    e_t = tinv.InvariantViolation("free-range", "msg", {"key": (0, "v")})
    e_j = jinv.InvariantViolation("free-range", "msg", {"key": (0, "v")})
    assert str(e_t) == str(e_j) and isinstance(e_t, AssertionError)
    from repro_torch import analysis
    assert analysis.InvariantViolation is tinv.InvariantViolation
    assert analysis.sanitize_enabled is tinv.sanitize_enabled


# ---------------------------------------------------------------------------
# planted faults through the hooked entry points
# ---------------------------------------------------------------------------

def _mini(side):
    tr = (jtrace, ttrace)[side]
    cluster = tr.simulation_cluster()
    return cluster, tr.philly_trace(n_jobs=6, seed=3, types=cluster.gpu_types)


def _both(fn):
    """``fn(side)`` for the reference (0) and the port (1): the same
    invariant, or no violation in both."""
    outs = []
    for side in (0, 1):
        try:
            fn(side)
        except (jinv.InvariantViolation, tinv.InvariantViolation) as e:
            assert isinstance(e, (jinv, tinv)[side].InvariantViolation)
            outs.append(e.invariant)
        else:
            outs.append(None)
    assert outs[0] == outs[1]
    return outs[1]


def _price_state(side, **kw):
    cluster, jobs = _mini(side)
    return (JPriceState, PriceState)[side](cluster, jobs, 86400.0, **kw)


def test_price_state_planted_faults_match_jax_package(monkeypatch):
    def overcommit(side):
        ps = _price_state(side, sanitize=True)
        ps.commit({ps.keys[0]: int(ps.cap_arr[0]) + 5})

    def bad_release(side):
        ps = _price_state(side, sanitize=True)
        ps.commit({ps.keys[0]: 1})
        ps.release({ps.keys[0]: 3})

    def negative(side):
        ps = _price_state(side, sanitize=True)
        ps.commit_batch([{ps.keys[0]: -1}])

    def cycle(side):
        ps = _price_state(side, sanitize=True)
        ps.commit({ps.keys[0]: 2})
        ps.commit_batch([{ps.keys[1]: 1}, {ps.keys[0]: 1}])
        ps.release({ps.keys[0]: 3})
        ps.release({ps.keys[1]: 1})
        ps.refresh(_mini(side)[1], now=0.0)
        assert ps._conserved
        np.testing.assert_array_equal(ps.free_arr, ps.cap_arr)

    def direct_gamma(side):
        ps = _price_state(side, sanitize=True)
        ps.gamma[ps.keys[0]] = 2        # external occupancy replay
        assert not ps._conserved
        ps.commit({ps.keys[1]: 1})      # no false conservation alarm
        ps.release({ps.keys[1]: 4})     # nor on the clamped release

    assert _both(overcommit) == "free-range"
    assert _both(bad_release) == "conservation"
    assert _both(negative) == "free-range"
    assert _both(cycle) is None
    assert _both(direct_gamma) is None
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    ps = _price_state(1)
    assert ps._sanitize is False
    ps.commit({ps.keys[0]: int(ps.cap_arr[0]) + 5})   # silent when off
    assert ps.free_arr[0] < 0
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert _price_state(1)._sanitize is True


@pytest.mark.parametrize("max_exact", [64, 2])
def test_dp_allocation_planted_faults_match_jax_package(max_exact,
                                                        monkeypatch):
    """A clean selection passes both ways (exact DP and greedy); a planted
    partial gang, and on the greedy path (the exact DP never selects a
    non-positive payoff) a planted zero payoff, trip the same invariant in
    both packages."""
    def run(side):
        cluster, jobs = _mini(side)
        ps = (JPriceState, PriceState)[side](cluster, jobs, 86400.0)
        return (jdp, tdp)[side].dp_allocation(
            jobs, cluster.free_map({}), ps, 0.0, (j_util,
                                                  effective_throughput)[side],
            max_exact=max_exact, sanitize=True)

    assert _both(run) is None
    planted = [(lambda c: c.__class__(
        {k: v + 1 for k, v in c.alloc.items()}, c.cost, c.payoff, c.rate),
        "gang-atomicity")]
    if max_exact < 6:
        planted.append((lambda c: c.__class__(c.alloc, c.cost, 0.0, c.rate),
                        "payoff-positive"))
    for edit, inv in planted:
        with monkeypatch.context() as m:
            for mod in (jdp, tdp):
                real = mod._find_alloc_arrays

                def planted(*a, _real=real, **kw):
                    c = _real(*a, **kw)
                    return None if c is None else edit(c)
                m.setattr(mod, "_find_alloc_arrays", planted)
            assert _both(run) == inv


class _Oversubscribing:
    """Allocates the same devices to every job."""
    name = "oversub"
    preemptive = True
    stable_when_idle = False

    def schedule(self, now, round_len, jobs, cluster):
        node = cluster.nodes[0]
        gpu = next(iter(node.gpus))
        return {j.job_id: {(node.node_id, gpu): j.n_workers}
                for j in jobs if not j.is_done() and j.arrival <= now}


class _PartialGang:
    """Gives every job one device regardless of its gang size."""
    name = "partial"
    preemptive = True
    stable_when_idle = False

    def schedule(self, now, round_len, jobs, cluster):
        out = {}
        for i, j in enumerate(jobs):
            if j.is_done() or j.arrival > now:
                continue
            node = cluster.nodes[i % len(cluster.nodes)]
            out[j.job_id] = {(node.node_id, next(iter(node.gpus))): 1}
        return out


@pytest.mark.parametrize("engine", ["simulate_rounds", "simulate_events"])
def test_engines_planted_faults_match_jax_package(engine):
    opts = ({"max_rounds": 3} if engine == "simulate_rounds"
            else {"max_events": 50})

    def oversub(side):
        cluster, jobs = _mini(side)
        getattr((jengine, tengine)[side], engine)(
            _Oversubscribing(), jobs, cluster, sanitize=True, **opts)

    def partial(side):
        cluster, jobs = _mini(side)
        jobs = [j for j in jobs if j.n_workers > 1]
        assert jobs
        getattr((jengine, tengine)[side], engine)(
            _PartialGang(), jobs, cluster, sanitize=True, **opts)

    assert _both(oversub) == "conservation"
    assert _both(partial) == "gang-atomicity"


def test_env_bad_action_matches_jax_package():
    def bad_action(side):
        C, N, J = ((JCluster, JNode, JJob), (Cluster, Node, Job))[side]
        cluster = C([N(0, {"v100": 1})])
        jobs = [J(0, 0.0, 1, 10, 100, {"v100": 1.0}),
                J(1, 0.0, 1, 10, 100, {"v100": 1.0})]
        env = (jenv, tenv)[side].ClusterSchedulingEnv(jobs, cluster,
                                                      sanitize=True)
        env.reset()
        env.step({0: {(0, "v100"): 1}, 1: {(0, "v100"): 1}})

    assert _both(bad_action) == "conservation"


def test_hadare_planted_fault_matches_jax_package():
    """HadarE under ``sanitize=True``: clean on a small trace in both
    packages, and a scheduler that stacks every copy on one node trips
    the same invariant."""
    class Stacking(_Oversubscribing):
        stable_when_idle = True

    def clean(side):
        cluster, jobs = _mini(side)
        sched = (JHadar, HadarScheduler)[side](solver="numpy")
        (jadapters, tadapters)[side].simulate_hadare(
            jobs, cluster, scheduler=sched, max_rounds=150, sanitize=True)

    def stacked(side):
        cluster, jobs = _mini(side)
        (jadapters, tadapters)[side].simulate_hadare(
            jobs, cluster, scheduler=Stacking(), max_rounds=5,
            sanitize=True)

    assert _both(clean) is None
    assert _both(stacked) == "conservation"


def test_queue_and_recorder_planted_faults_match_jax_package():
    def recorder(side):
        rec = (JRecorder, MetricsRecorder)[side](4, 2, sanitize=True)
        rec.close_interval(0.0, 1.0, 10.0, {0}, 1, 0, 0, 0.0)

    def queue(side):
        q = (JEventQueue, EventQueue)[side](sanitize=True)
        q.push_arrival(1.0, 1)
        q.push_arrival(5.0, 2)
        assert q.pop_batch()[0].time == 1.0
        assert q.pop_batch()[0].time == 5.0
        q.push_arrival(2.0, 3)           # before the last pop
        q.pop_batch()

    assert _both(recorder) == "gru-cru-range"
    assert _both(queue) == "time-monotonic"


# ---------------------------------------------------------------------------
# the batched solver's hooks (port only: the JAX kernels do not run here)
# ---------------------------------------------------------------------------

def _greedy_case():
    cluster = ttrace.grown_cluster(40)
    jobs = ttrace.philly_trace(n_jobs=40, seed=1, types=cluster.gpu_types)
    ps = PriceState(cluster, jobs, 7 * 86400.0, device="cpu")
    return jobs, ps


def _greedy(jobs, ps, sanitize):
    return tdp.dp_allocation(jobs, None, ps, 0.0, effective_throughput,
                             max_exact=24, solver="cuda", sanitize=sanitize)


def test_commit_scan_carry_mismatch(monkeypatch):
    """K5's carried free vector is checked against the host's commit on
    every call: a planted mismatch raises ``RuntimeError`` with the
    sanitizer off and ``InvariantViolation("conservation")`` with it on;
    unplanted, the sanitized greedy pass equals the NumPy one."""
    jobs, ps = _greedy_case()
    want = tdp.dp_allocation(jobs, None, ps, 0.0, effective_throughput,
                             max_exact=24, solver="numpy")
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert _greedy(jobs, ps, True) == want
    real = ops.commit_scan
    scans = []

    def planted(*a, **kw):
        out = list(real(*a, **kw))
        out[0] = out[0] + 1.0
        scans.append(1)
        return tuple(out)
    monkeypatch.setattr(ops, "commit_scan", planted)
    with pytest.raises(tinv.InvariantViolation) as ei:
        _greedy(jobs, ps, True)
    assert ei.value.invariant == "conservation"
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    with pytest.raises(RuntimeError, match="carried free vector"):
        _greedy(jobs, ps, False)
    assert len(scans) == 2


def test_find_alloc_batch_checks_each_candidate(monkeypatch):
    """Under the sanitizer every candidate K4's winners make is checked:
    a planted take count (one worker short) trips gang atomicity."""
    jobs, ps = _greedy_case()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    clean = tbs.find_alloc_batch(jobs, ps.free_arr.copy(),
                                 ps.gamma_arr.copy(), ps, 0.0,
                                 effective_throughput)
    assert any(c is not None for c in clean)
    real = ops.find_alloc

    def planted(*a, **kw):
        out = list(real(*a, **kw))
        out[3] = out[3] - (out[3] > 0).to(out[3].dtype)
        return tuple(out)
    monkeypatch.setattr(ops, "find_alloc", planted)
    with pytest.raises(tinv.InvariantViolation) as ei:
        tbs.find_alloc_batch(jobs, ps.free_arr.copy(), ps.gamma_arr.copy(),
                             ps, 0.0, effective_throughput)
    assert ei.value.invariant == "gang-atomicity"


# ---------------------------------------------------------------------------
# sanitized runs are bitwise equal to unsanitized ones
# ---------------------------------------------------------------------------

MODEL = dict(seed=5, mtbf_hours=6.0, spot_frac=0.3, spot_reclaim_hours=4.0,
             recovery_dist="uniform", horizon=4 * 86400.0)


@pytest.mark.parametrize("run", ["hadar_rounds", "hadar_events",
                                 "hadar_cuda_cpu", "gavel", "hadare"])
def test_sanitized_runs_bitwise_equal(run, monkeypatch):
    """Every hook on (``REPRO_SANITIZE=1``: PriceState, dp_allocation and
    the batched solver as well as the engine) against every hook off,
    under a failure model; Hadar's round run without one (see
    ``test_round_engine_down_alloc_matches_jax_package``)."""
    cluster = ttrace.simulation_cluster()
    jobs = ttrace.philly_trace(n_jobs=12, seed=4, types=cluster.gpu_types)

    def go(sanitize):
        monkeypatch.setenv("REPRO_SANITIZE", "1" if sanitize else "0")
        faults = (None if run == "hadar_rounds"
                  else tfaults.FailureModel(**MODEL))
        if run == "hadare":
            return tadapters.simulate_hadare(
                clone_jobs(jobs), cluster, faults=faults, sanitize=sanitize,
                scheduler=HadarScheduler(solver="numpy"))
        if run == "gavel":
            return tengine.simulate_rounds(GavelScheduler(),
                                           clone_jobs(jobs), cluster,
                                           faults=faults, sanitize=sanitize)
        sched = (HadarScheduler(solver="cuda", device="cpu")
                 if run == "hadar_cuda_cpu"
                 else HadarScheduler(solver="numpy"))
        engine = (tengine.simulate_rounds if run == "hadar_rounds"
                  else tengine.simulate_events)
        return engine(sched, clone_jobs(jobs), cluster, faults=faults,
                      sanitize=sanitize)

    plain, checked = go(False), go(True)
    assert result_fields(checked) == result_fields(plain)
    assert (plain.evictions > 0) == (run != "hadar_rounds")


def test_round_engine_down_alloc_matches_jax_package():
    """The JAX package's round engine keeps a finished job's allocation
    until the next round, and its eviction pass skips finished jobs, so
    its sanitizer reports a down-alloc when a node under such a job fails
    at the round start.  The port keeps the engine and the check as they
    are, and trips at the same point with the same snapshot."""
    def run(side):
        tr, F, eng, H = ((jtrace, jfaults, jengine, JHadar),
                         (ttrace, tfaults, tengine, HadarScheduler))[side]
        cluster = tr.simulation_cluster()
        jobs = tr.philly_trace(n_jobs=12, seed=4, types=cluster.gpu_types)
        eng.simulate_rounds(H(solver="numpy"), jobs, cluster,
                            faults=F.FailureModel(**MODEL), sanitize=True)

    outs = []
    for side in (0, 1):
        with pytest.raises((jinv, tinv)[side].InvariantViolation) as ei:
            run(side)
        outs.append((ei.value.invariant, ei.value.snapshot))
    assert outs[1] == outs[0] and outs[1][0] == "down-alloc"

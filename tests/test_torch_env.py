"""The port's scheduling env and classic baselines (``repro_torch.env``)
against the JAX package's (``repro.env``), on the CPU.

The same traces and clusters, built from fixed seeds for both packages:
every classic baseline consult by consult through both engines, with and
without faults; ``run_policy`` episodes of the seven policies of the
reference's env tests, each step's observation (``price`` included), the
reward trajectory of every reward and the result; the env's lifecycle
cases and its faults passthrough.  Results are compared in every field
but ``sched_seconds`` (host time).  Hadar runs in both packages with
``solver="numpy"``, and the port once more on its batched path
(``solver="cuda", device="cpu"``: the kernels' plain versions).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.core import schedulers as jsched
from repro.core import trace as jtrace
from repro.core.hadar import HadarScheduler as JHadar
from repro.core.types import Cluster as JCluster
from repro.core.types import Job as JJob
from repro.core.types import Node as JNode
from repro.env import baselines as jbase
from repro.env import env as jenv
from repro.sim import engine as jengine
from repro.sim import faults as jfaults
from repro_torch.core import schedulers as tsched
from repro_torch.core import trace as ttrace
from repro_torch.core.hadar import HadarScheduler
from repro_torch.core.types import Cluster, Job, Node, clone_jobs
from repro_torch.env import baselines as tbase
from repro_torch.env import env as tenv
from repro_torch.sim import engine as tengine
from repro_torch.sim import faults as tfaults
from repro_torch.sim.metrics import result_fields

MODEL = dict(seed=5, mtbf_hours=6.0, spot_frac=0.3, spot_reclaim_hours=4.0,
             recovery_dist="uniform", horizon=4 * 86400.0)
# the classic baselines: (class name, constructor keywords)
BASELINES = [("FCFSScheduler", {}), ("SJFScheduler", {}),
             ("SJFScheduler", {"predicted": True}), ("SRTFScheduler", {}),
             ("SRTFScheduler", {"predicted": True}),
             ("MaxMinShareScheduler", {})]
BASELINE_IDS = ["fcfs", "sjf", "sjf_pred", "srtf", "srtf_pred", "maxmin"]
# the factories of the reference's env replay test, by name; each builds
# (reference scheduler, port scheduler)
POLICIES = {
    "fcfs": lambda: (jbase.FCFSScheduler(), tbase.FCFSScheduler()),
    "sjf": lambda: (jbase.SJFScheduler(), tbase.SJFScheduler()),
    "sjf_pred": lambda: (jbase.SJFScheduler(predicted=True),
                         tbase.SJFScheduler(predicted=True)),
    "srtf": lambda: (jbase.SRTFScheduler(), tbase.SRTFScheduler()),
    "maxmin": lambda: (jbase.MaxMinShareScheduler(),
                       tbase.MaxMinShareScheduler()),
    "tiresias": lambda: (jsched.TiresiasScheduler(),
                         tsched.TiresiasScheduler()),
    "hadar": lambda: (JHadar(solver="numpy"), HadarScheduler(solver="numpy")),
    "hadar_cuda_cpu": lambda: (JHadar(solver="numpy"),
                               HadarScheduler(solver="cuda", device="cpu")),
}


def _recording(cls):
    """``cls`` noting each consult's time, view and decisions."""
    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.log = []

        def schedule(self, now, round_len, jobs, cluster):
            out = super().schedule(now, round_len, jobs, cluster)
            self.log.append((now, [n.node_id for n in cluster.nodes],
                             sorted((k, sorted(v.items()))
                                    for k, v in out.items())))
            return out
    return Recording


def _trace(side, n, seed):
    """(staggered fig5 jobs, simulation_cluster()) of one package, as the
    reference's env tests build them; side 0 the reference."""
    tr = (jtrace, ttrace)[side]
    return (tr.philly_trace(n_jobs=n, seed=seed),
            tr.simulation_cluster())


def _sanitized(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")


# ---------------------------------------------------------------------------
# the classic baselines through both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["simulate_rounds", "simulate_events"])
@pytest.mark.parametrize("faults", [None, "model"])
@pytest.mark.parametrize("idx", range(len(BASELINES)), ids=BASELINE_IDS)
def test_baseline_runs_match_jax_package(idx, faults, engine):
    """32 staggered fig5 jobs on simulation_cluster(): every consult's
    decisions, and the result, equal to the reference's."""
    name, kw = BASELINES[idx]
    (jjobs, jcl), (tjobs, tcl) = _trace(0, 32, 3), _trace(1, 32, 3)
    jsch = _recording(getattr(jbase, name))(**kw)
    tsch = _recording(getattr(tbase, name))(**kw)
    jf = jfaults.FailureModel(**MODEL) if faults else None
    tf = tfaults.FailureModel(**MODEL) if faults else None
    want = getattr(jengine, engine)(jsch, jjobs, jcl, faults=jf)
    got = getattr(tengine, engine)(tsch, tjobs, tcl, faults=tf)
    assert tsch.name == jsch.name
    assert tsch.log == jsch.log and len(tsch.log) > 5
    assert result_fields(got) == result_fields(want)
    assert all(j.finish_time is not None for j in got.jobs)
    assert (got.evictions > 0) == bool(faults)


@pytest.mark.parametrize("n", [6, 7])
@pytest.mark.parametrize("engine", ["simulate_rounds", "simulate_events"])
def test_baselines_on_reference_engine_gap_traces(n, engine, monkeypatch):
    """The traces on which the reference's round and event runs of the
    blind baselines disagree beyond its own tolerance (seed 2023,
    staggered): the port's runs equal the reference's own, run by run,
    under the sanitizer in both packages."""
    _sanitized(monkeypatch)
    for idx, (name, kw) in enumerate(BASELINES):
        (jjobs, jcl), (tjobs, tcl) = _trace(0, n, 2023), _trace(1, n, 2023)
        jsch = _recording(getattr(jbase, name))(**kw)
        tsch = _recording(getattr(tbase, name))(**kw)
        opts = {"max_rounds": 8000} if engine == "simulate_rounds" else {}
        want = getattr(jengine, engine)(jsch, jjobs, jcl, **opts)
        got = getattr(tengine, engine)(tsch, tjobs, tcl, **opts)
        assert tsch.log == jsch.log, BASELINE_IDS[idx]
        assert result_fields(got) == result_fields(want), BASELINE_IDS[idx]


def test_duration_noise_and_helpers_match_jax_package():
    """The misprediction stream keyed on (seed, job id), the estimator's
    seconds, and the type-blind gang on a mixed cluster: bitwise the
    reference's."""
    for seed in (0, 1, 7, 12345):
        for job_id in (0, 1, 9, 4242, 2 ** 31):
            for sigma in (0.0, 0.35, 1.0):
                assert tbase._duration_noise(job_id, seed, sigma) == \
                    jbase._duration_noise(job_id, seed, sigma)
    (jjobs, jcl), (tjobs, tcl) = _trace(0, 24, 5), _trace(1, 24, 5)
    jest = jbase._DurationEstimator(True, 0.35, 3)
    test = tbase._DurationEstimator(True, 0.35, 3)
    for jj, tj in zip(jjobs, tjobs):
        jj.done_iters = tj.done_iters = jj.total_iters / 3.0
        assert test.total_seconds(tj) == jest.total_seconds(jj)
        assert test.remaining_seconds(tj) == jest.remaining_seconds(jj)
        assert tbase._can_ever_fit(tcl, tj) == jbase._can_ever_fit(jcl, jj)
        taken = {(0, "v100"): 2, (10, "k80"): 1}
        assert tbase._blind_gang(tcl, taken, tj) == \
            jbase._blind_gang(jcl, taken, jj)
    big = Job(0, 0.0, 10 ** 4, 1, 1, {"v100": 1.0})
    assert not tbase._can_ever_fit(tcl, big)
    assert tbase._fits(tcl, {}, {(0, "v100"): 4})
    assert not tbase._fits(tcl, {(0, "v100"): 1}, {(0, "v100"): 4})


# ---------------------------------------------------------------------------
# run_policy episodes: observations, rewards and results
# ---------------------------------------------------------------------------

def _episode(env, sched):
    """``run_policy``'s loop written out, noting every observation."""
    env.stable = bool(getattr(sched, "stable_when_idle", False))
    env.name = sched.name
    obs, info = env.reset()
    seen, rewards = [obs], []
    while info["consult"] is not None:
        cp = info["consult"]
        if cp.completed and hasattr(sched, "note_completion"):
            sched.note_completion()
        obs, reward, terminated, truncated, info = env.step(
            sched.schedule(cp.t, cp.round_len, cp.jobs, cp.view))
        seen.append(obs)
        rewards.append(reward)
        if terminated or truncated:
            break
    return env.result, rewards, seen


def _same_obs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype, key
            assert np.array_equal(g[key], w[key]), key


@pytest.mark.parametrize("reward", ["neg_jct", "gru", "goodput"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_run_policy_matches_jax_package(policy, reward):
    """10 fig5 jobs (seed 3): each step's observation, the reward
    trajectory and the result equal the reference env's; ``run_policy``
    gives the same result and rewards as the loop, and as
    ``simulate_events``."""
    (jjobs, jcl), (tjobs, tcl) = _trace(0, 10, 3), _trace(1, 10, 3)
    jsch, tsch = POLICIES[policy]()
    want, want_r, want_obs = _episode(
        jenv.ClusterSchedulingEnv(jjobs, jcl, reward=reward), jsch)
    got, got_r, got_obs = _episode(
        tenv.ClusterSchedulingEnv(tjobs, tcl, reward=reward), tsch)
    _same_obs(got_obs, want_obs)
    assert got_r == want_r
    assert result_fields(got) == result_fields(want)
    if policy in ("fcfs", "hadar_cuda_cpu"):
        res, rew = tenv.run_policy(
            tenv.ClusterSchedulingEnv(tjobs, tcl, reward=reward),
            POLICIES[policy]()[1])
        assert rew == got_r and result_fields(res) == result_fields(got)
        direct = tengine.simulate_events(POLICIES[policy]()[1],
                                         clone_jobs(tjobs), tcl)
        assert result_fields(direct) == result_fields(got)


def test_hadar_episode_on_the_greedy_path_matches_jax_package(monkeypatch):
    """24 fig5 jobs arriving together on grown_cluster(24), with the exact
    DP cut to queues of 6 in both packages: the port's batched path takes
    the greedy commit (conflict-free waves and K5's plain version).  Its
    episode, price observations included, equals the reference's NumPy
    one."""
    from repro_torch.kernels import ops
    scans = []
    real = ops.commit_scan
    monkeypatch.setattr(ops, "commit_scan",
                        lambda *a, **kw: scans.append(1) or real(*a, **kw))
    tcl = ttrace.grown_cluster(24)
    jcl = JCluster([JNode(n.node_id, dict(n.gpus)) for n in tcl.nodes])
    jjobs = jtrace.philly_trace(n_jobs=24, seed=1, types=jcl.gpu_types)
    tjobs = ttrace.philly_trace(n_jobs=24, seed=1, types=tcl.gpu_types)
    want, want_r, want_obs = _episode(
        jenv.ClusterSchedulingEnv(jjobs, jcl),
        JHadar(solver="numpy", max_exact_dp=6))
    got, got_r, got_obs = _episode(
        tenv.ClusterSchedulingEnv(tjobs, tcl),
        HadarScheduler(solver="cuda", device="cpu", max_exact_dp=6))
    _same_obs(got_obs, want_obs)
    assert got_r == want_r
    assert result_fields(got) == result_fields(want)
    assert scans


def test_same_seed_episodes_bitwise_reproducible():
    tjobs, tcl = _trace(1, 8, 7)
    r1, rew1 = tenv.run_policy(tenv.ClusterSchedulingEnv(tjobs, tcl),
                               tbase.SJFScheduler(predicted=True, seed=4),
                               seed=0)
    r2, rew2 = tenv.run_policy(tenv.ClusterSchedulingEnv(tjobs, tcl),
                               tbase.SJFScheduler(predicted=True, seed=4),
                               seed=0)
    assert result_fields(r1) == result_fields(r2) and rew1 == rew2


def test_reward_catalogue_matches_jax_package():
    """Each reward on the same windows, edge cases included (no live
    capacity, losses beyond busy time, unfinished jobs)."""
    for t0, t1, busy, avail, lost in [(0.0, 360.0, 100.0, 400.0, 0.0),
                                      (10.0, 20.0, 5.0, 0.0, 1.0),
                                      (5.0, 900.0, 50.0, 60.0, 80.0)]:
        jj = [JJob(i, 30.0 * i, 1, 1, 1, {"v100": 1.0}) for i in range(4)]
        tj = [Job(i, 30.0 * i, 1, 1, 1, {"v100": 1.0}) for i in range(4)]
        jj[1].finish_time = tj[1].finish_time = 200.0
        for name in ("neg_jct", "gru", "goodput"):
            want = jenv.REWARDS[name](jenv.StepWindow(
                t0, t1, jj, [1], busy, avail, lost, 0))
            got = tenv.REWARDS[name](tenv.StepWindow(
                t0, t1, tj, [1], busy, avail, lost, 0))
            assert got == want, name
    assert sorted(tenv.REWARDS) == sorted(jenv.REWARDS)


def test_neg_jct_telescopes_and_gru_windows_tile():
    tjobs, tcl = _trace(1, 8, 1)
    res, rewards = tenv.run_policy(
        tenv.ClusterSchedulingEnv(tjobs, tcl, reward="neg_jct"),
        tbase.FCFSScheduler())
    assert all(j.finish_time is not None for j in res.jobs)
    total_jct = sum(j.finish_time - j.arrival for j in res.jobs)
    assert sum(rewards) == pytest.approx(-total_jct / 3600.0, abs=1e-6)
    windows = []
    res, _ = tenv.run_policy(tenv.ClusterSchedulingEnv(
        tjobs, tcl, reward=lambda w: windows.append(w) or 0.0),
        tbase.SRTFScheduler())
    assert sum(w.busy for w in windows) == pytest.approx(
        res.gpu_seconds_busy, abs=1e-6)
    assert sum(w.avail for w in windows) == pytest.approx(
        res.gpu_seconds_avail, abs=1e-6)
    assert windows[0].t0 == 0.0
    assert all(a.t1 == b.t0 for a, b in zip(windows, windows[1:]))
    assert windows[-1].t1 == pytest.approx(res.total_seconds)


# ---------------------------------------------------------------------------
# observations and the gym lifecycle
# ---------------------------------------------------------------------------

def test_observation_consistency_every_step():
    tjobs, tcl = _trace(1, 8, 4)
    env = tenv.ClusterSchedulingEnv(tjobs, tcl, stable=True)
    sched = tbase.SRTFScheduler()
    obs, info = env.reset()
    n_keys = sum(len(n.gpus) for n in tcl.nodes)
    terminated = False
    while not terminated:
        assert obs["queue"].shape == (len(obs["queue_ids"]), 5)
        assert obs["running"].shape == (len(obs["running_ids"]), 6)
        assert not set(obs["queue_ids"]) & set(obs["running_ids"])
        assert obs["free"].shape == obs["capacity"].shape == (n_keys,)
        assert obs["price"].shape == (n_keys,)
        assert (obs["free"] >= 0.0).all()
        assert (obs["free"] <= obs["capacity"]).all()
        assert (obs["price"] > 0.0).all() and np.isfinite(obs["price"]).all()
        assert obs["down"].shape == (len(tcl.nodes),)
        assert not obs["down"].any()
        assert len(obs["queue_ids"]) == info["queue_len"]
        cp = info["consult"]
        obs, _, terminated, _, info = env.step(
            sched.schedule(cp.t, cp.round_len, cp.jobs, cp.view))
    assert (obs["free"] == obs["capacity"]).all()


def test_price_obs_needs_no_card(monkeypatch):
    """The price observation is built on the host: it never asks for a
    device view, so no CUDA is needed; off, it is left out."""
    from repro_torch.core import pricing

    def no_view(self, name):
        raise AssertionError("the env took a device view")
    monkeypatch.setattr(pricing.PriceState, "device_view", no_view)
    tjobs, tcl = _trace(1, 4, 0)
    obs, _ = tenv.ClusterSchedulingEnv(tjobs, tcl).reset()
    assert np.isfinite(obs["price"]).all()
    obs, _ = tenv.ClusterSchedulingEnv(tjobs, tcl, price_obs=False).reset()
    assert "price" not in obs and "free" in obs and "queue" in obs


def test_lifecycle_errors_match_jax_package():
    """Unknown reward, step before reset and after the end, a bad action
    type, an empty trace: the port raises what the reference raises."""
    for side, (mod, cl) in enumerate(((jenv, jtrace.simulation_cluster()),
                                      (tenv, ttrace.simulation_cluster()))):
        jobs = _trace(side, 2, 0)[0]
        with pytest.raises(ValueError, match="unknown reward"):
            mod.ClusterSchedulingEnv(jobs, cl, reward="profit")
        env = mod.ClusterSchedulingEnv(jobs, cl)
        with pytest.raises(RuntimeError, match="reset"):
            env.step(None)
        env.reset()
        with pytest.raises(TypeError, match="Dict"):
            env.step([1, 2, 3])
        mod.run_policy(env, (jbase, tbase)[side].FCFSScheduler())
        with pytest.raises(RuntimeError, match="reset"):
            env.step(None)
        empty = mod.ClusterSchedulingEnv([], cl)
        obs, info = empty.reset()
        assert info["result"] is not None and obs["queue"].shape == (0, 5)
        with pytest.raises(RuntimeError):
            empty.step(None)


def test_max_steps_truncates_as_jax_package():
    outs = []
    for side, (mod, base) in enumerate(((jenv, jbase), (tenv, tbase))):
        jobs, cl = _trace(side, 8, 3)
        env = mod.ClusterSchedulingEnv(jobs, cl, max_steps=3)
        sched = base.FCFSScheduler()
        obs, info = env.reset()
        seen = []
        truncated = terminated = False
        while not (terminated or truncated):
            cp = info["consult"]
            obs, r, terminated, truncated, info = env.step(
                sched.schedule(cp.t, cp.round_len, cp.jobs, cp.view))
            seen.append((r, terminated, truncated, info["t"],
                         info["queue_len"]))
        assert env.result is None
        outs.append(seen)
    assert outs[1] == outs[0] and len(outs[1]) == 3 and outs[1][-1][2]


def test_template_jobs_never_mutated_and_factory_reseeds():
    tjobs, tcl = _trace(1, 4, 2)
    env = tenv.ClusterSchedulingEnv(tjobs, tcl)
    r1, _ = tenv.run_policy(env, tbase.FCFSScheduler())
    assert all(j.finish_time is None and j.done_iters == 0.0
               and j.alloc is None for j in tjobs)
    r2, _ = tenv.run_policy(env, tbase.FCFSScheduler())
    assert result_fields(r1) == result_fields(r2)

    def factory(seed):
        return ttrace.philly_trace(n_jobs=4, seed=seed)
    env = tenv.ClusterSchedulingEnv(factory(0), tcl, trace_factory=factory)
    r0, rew0 = tenv.run_policy(env, tbase.FCFSScheduler(), seed=0)
    r1, _ = tenv.run_policy(env, tbase.FCFSScheduler(), seed=1)
    assert result_fields(r0) != result_fields(r1)
    r0b, rew0b = tenv.run_policy(env, tbase.FCFSScheduler(), seed=0)
    assert result_fields(r0) == result_fields(r0b) and rew0 == rew0b


def test_render_matches_jax_package():
    texts = []
    for side, (mod, base) in enumerate(((jenv, jbase), (tenv, tbase))):
        jobs, cl = _trace(side, 2, 0)
        env = mod.ClusterSchedulingEnv(jobs, cl, name="smoke")
        seen = [env.render()]
        env.reset()
        seen.append(env.render())
        mod.run_policy(env, base.FCFSScheduler())
        seen.append(env.render())
        env.close()
        texts.append(seen)
    assert texts[1] == texts[0]
    assert "not started" in texts[1][0] and "episode over" in texts[1][2]


# ---------------------------------------------------------------------------
# faults passthrough
# ---------------------------------------------------------------------------

def _outage_case(side):
    C, N, J = ((JCluster, JNode, JJob), (Cluster, Node, Job))[side]
    F = (jfaults, tfaults)[side]
    cluster = C([N(0, {"v100": 2}), N(1, {"v100": 2})])
    jobs = [J(i, 0.0, 1, 10, 100, {"v100": 1.0}) for i in range(4)]
    return jobs, cluster, F.FailureTrace([F.FaultWindow(0, 120.0, 400.0)])


def test_env_faults_passthrough_matches_jax_package():
    """A node outage shows in the observations (down mask, zero free,
    +inf price on the down node's key) and the episode equals both the
    port's ``simulate_events`` and the reference env, step by step."""
    runs = []
    for side, (mod, base) in enumerate(((jenv, jbase), (tenv, tbase))):
        jobs, cluster, ft = _outage_case(side)
        env = mod.ClusterSchedulingEnv(jobs, cluster, faults=ft)
        runs.append(_episode(env, base.SRTFScheduler()))
    (want, want_r, want_obs), (got, got_r, got_obs) = runs
    _same_obs(got_obs, want_obs)
    assert got_r == want_r and result_fields(got) == result_fields(want)
    down = [o for o in got_obs if o["down"].any()]
    assert down
    for o in down:
        assert o["down"][0] == 1.0 and o["down"][1] == 0.0
        assert o["free"][0] == 0.0 and np.isinf(o["price"][0])
    jobs, cluster, ft = _outage_case(1)
    direct = tengine.simulate_events(tbase.SRTFScheduler(),
                                     clone_jobs(jobs), cluster, faults=ft)
    assert result_fields(direct) == result_fields(got)
    assert got.evictions >= 1
    assert got.goodput() <= got.gru_overall() + 1e-9
    assert all(j.finish_time is not None for j in got.jobs)


def test_env_faults_model_on_fig5_matches_jax_package():
    """A seeded failure model over 16 fig5 jobs, Hadar on its NumPy path:
    every observation, reward and result field equal the reference's."""
    runs = []
    for side in (0, 1):
        jobs, cl = _trace(side, 16, 2)
        F = (jfaults, tfaults)[side]
        mod = (jenv, tenv)[side]
        sched = (JHadar, HadarScheduler)[side](solver="numpy")
        env = mod.ClusterSchedulingEnv(jobs, cl, reward="goodput",
                                       faults=F.FailureModel(**MODEL))
        runs.append(_episode(env, sched))
    (want, want_r, want_obs), (got, got_r, got_obs) = runs
    _same_obs(got_obs, want_obs)
    assert got_r == want_r and result_fields(got) == result_fields(want)
    assert got.evictions > 0


# ---------------------------------------------------------------------------
# the smoke's env phase, at a small size with the kernels' plain versions
# ---------------------------------------------------------------------------

def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_env_episode_checks_every_step():
    """``chip_smoke.run_env`` on 12 fig5 jobs under a failure model (the
    kernels' plain versions): its episode equals ``simulate_events`` of
    the same scheduler, every observation passes ``check_obs``, and the
    rewards telescope."""
    smoke = _smoke()
    cl = ttrace.grown_cluster(12)
    jobs = ttrace.philly_trace(n_jobs=12, seed=1, types=cl.gpu_types)
    model = tfaults.FailureModel(**MODEL)
    run = smoke.run_env(jobs, cl, model, "cuda", device="cpu")
    direct = tengine.simulate_events(HadarScheduler(solver="numpy"),
                                     clone_jobs(jobs), cl, faults=model)
    assert run["fields"] == result_fields(direct)
    assert run["steps"] == direct.sched_calls and run["obs_checked"] > 0
    assert run["obs_s"] > 0.0 and run["res"].evictions > 0
    assert smoke.check_rewards(run["res"], run["rewards"])


def test_smoke_check_obs_rejects_a_bad_observation():
    smoke = _smoke()
    jobs, cl = _trace(1, 6, 1)
    env = tenv.ClusterSchedulingEnv(jobs, cl)
    obs, info = env.reset()
    cp = info["consult"]
    smoke.check_obs(obs, cp, env)
    for key, bad, match in (
            ("free", obs["free"] + 1.0, "free"),
            ("price", -obs["price"], "price"),
            ("queue_ids", obs["queue_ids"][:-1], "active")):
        with pytest.raises(RuntimeError, match=match):
            smoke.check_obs(dict(obs, **{key: bad}), cp, env)


def test_smoke_check_compare_holds_rows_to_the_reference():
    """``chip_smoke.check_compare`` takes the JAX package's rows as they
    come (NumPy floats included) and rejects a row off by more than
    REF_REL_TOL, a changed count, and a policy whose launches are not
    its own."""
    import copy
    smoke = _smoke()
    import repro_torch.env.compare as cmp
    rows = [dict(r) for r in smoke.REF_COMPARE]
    rows[2]["goodput"] = np.float64(rows[2]["goodput"])
    doc = {"schema": cmp.TABLE_SCHEMA, "trace": "t", "n_jobs": 48,
           "cluster": {"nodes": 15, "gpus": 60, "types": []},
           "mode": "event", "round_len": 360.0, "faulted": True,
           "policies": rows}
    none = {"flash_attention": 0, "rwkv6_scan": 0, "rmsnorm": 0,
            "find_alloc": 0, "commit_scan": 0}
    runs = {r["policy"]: {"launches": dict(none)} for r in rows}
    for name in smoke.COMPARE_KERNEL_POLICIES:
        runs[name]["launches"].update(find_alloc=9, commit_scan=2)
    smoke.check_compare(doc, runs)
    for policy, key, value in (("gavel", "gru", 1e-7),
                               ("fcfs", "evictions", 1),
                               ("hadar", "ttd_hours", 30.0)):
        bad = copy.deepcopy(doc)
        row = next(r for r in bad["policies"] if r["policy"] == policy)
        row[key] += value
        with pytest.raises(RuntimeError, match="env compare"):
            smoke.check_compare(bad, runs)
    for policy, kernel in (("fcfs", "find_alloc"), ("hadare", "rmsnorm")):
        bad = copy.deepcopy(runs)
        bad[policy]["launches"][kernel] += 1
        with pytest.raises(RuntimeError, match="launches"):
            smoke.check_compare(doc, bad)
    bad = copy.deepcopy(runs)
    bad["hadar"]["launches"]["commit_scan"] = 0
    with pytest.raises(RuntimeError, match="launches"):
        smoke.check_compare(doc, bad)

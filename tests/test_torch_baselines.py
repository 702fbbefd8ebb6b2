"""The port's Gavel, Tiresias and YARN-CS baselines against the JAX
package's, on the CPU.

The same traces and clusters, built from fixed seeds for both packages:
Gavel's allocation matrix, every decision of every consult (recorded
round by round inside a run), and whole runs of both engines with and
without faults, compared in every field but ``sched_seconds`` (host
time).  Gavel and Tiresias rotate allocations, so their event runs go
through the re-schedule quantum; YARN-CS is ``stable_when_idle``.
"""

import numpy as np
import pytest

from repro.core import schedulers as jsched
from repro.core import trace as jtrace
from repro.core.types import Cluster as JCluster
from repro.core.types import Job as JJob
from repro.core.types import Node as JNode
from repro.sim import engine as jengine
from repro.sim import faults as jfaults
from repro_torch.core import schedulers as tsched
from repro_torch.core import trace as ttrace
from repro_torch.core.types import Cluster, Job, Node
from repro_torch.sim import engine as tengine
from repro_torch.sim import faults as tfaults
from repro_torch.sim.metrics import result_fields

NAMES = ["GavelScheduler", "TiresiasScheduler", "YarnCSScheduler"]
TYPES = ["v100", "p100", "k80", "t4"]
# every K80 node of simulation_cluster() (nodes 10-14) down together
K80_OUTAGE = [(n, 20000.0, 90000.0, "fail") for n in range(10, 15)]
MODEL = dict(seed=5, mtbf_hours=6.0, spot_frac=0.3, spot_reclaim_hours=4.0,
             recovery_dist="uniform", horizon=4 * 86400.0)


def _recording(cls):
    """``cls`` noting each consult's time, view and decisions."""
    class Recording(cls):
        def __init__(self):
            super().__init__()
            self.log = []

        def schedule(self, now, round_len, jobs, cluster):
            out = super().schedule(now, round_len, jobs, cluster)
            self.log.append((now, [n.node_id for n in cluster.nodes],
                             sorted((k, sorted(v.items()))
                                    for k, v in out.items())))
            return out
    return Recording


def _pair(n, seed, topo):
    """(reference jobs, cluster), (port jobs, cluster) of one workload."""
    out = []
    for tr, C, N in ((jtrace, JCluster, JNode), (ttrace, Cluster, Node)):
        if topo == "sim":
            cl = tr.simulation_cluster()
        else:
            cl = tr.multi_cluster(n_pods=2, nodes_per_pod=4,
                                  gpus_per_node=4,
                                  pod_types=["v100", "p100", "k80"],
                                  mixed_frac=0.5, seed=seed)
        jobs = tr.philly_trace(n_jobs=n, seed=seed, all_at_start=False,
                               types=cl.gpu_types)
        out.append((jobs, cl))
    return out


FAULTS = {"none": (None, None),
          "model": (lambda: jfaults.FailureModel(**MODEL),
                    lambda: tfaults.FailureModel(**MODEL)),
          "k80_outage": (lambda: jfaults.FailureTrace(K80_OUTAGE),
                         lambda: tfaults.FailureTrace(K80_OUTAGE))}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("engine", ["simulate_rounds", "simulate_events"])
@pytest.mark.parametrize("faults", list(FAULTS))
def test_baseline_runs_match_jax_package(name, engine, faults):
    """48 jobs on simulation_cluster(): every consult's decisions, and the
    result, equal to the reference's."""
    (jjobs, jcl), (tjobs, tcl) = _pair(48, 3, "sim")
    jf, tf = FAULTS[faults]
    jsch = _recording(getattr(jsched, name))()
    tsch = _recording(getattr(tsched, name))()
    want = getattr(jengine, engine)(jsch, jjobs, jcl,
                                    faults=jf() if jf else None)
    got = getattr(tengine, engine)(tsch, tjobs, tcl,
                                   faults=tf() if tf else None)
    assert tsch.log == jsch.log and len(tsch.log) > 10
    assert result_fields(got) == result_fields(want)
    assert all(j.finish_time is not None for j in got.jobs)
    assert (got.evictions > 0) == (faults != "none")
    if faults == "k80_outage":
        assert min(len(v) for _, v, _ in tsch.log) == 10


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [1, 2])
def test_baseline_runs_on_mixed_pods_match_jax_package(name, seed):
    """64 jobs on a 2-pod multi_cluster with mixed nodes, through the event
    engine under a failure model."""
    (jjobs, jcl), (tjobs, tcl) = _pair(64, seed, "pods")
    jsch = _recording(getattr(jsched, name))()
    tsch = _recording(getattr(tsched, name))()
    want = jengine.simulate_events(jsch, jjobs, jcl,
                                   faults=jfaults.FailureModel(**MODEL))
    got = tengine.simulate_events(tsch, tjobs, tcl,
                                  faults=tfaults.FailureModel(**MODEL))
    assert tsch.log == jsch.log
    assert result_fields(got) == result_fields(want)


def _random_state(mods, seed):
    """A random cluster and queue built from ``mods`` (Cluster, Node, Job),
    some jobs already holding allocations and some attained service."""
    C, N, J = mods
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(int(rng.randint(3, 9))):
        picks = rng.choice(len(TYPES), size=int(rng.randint(1, 3)),
                           replace=False)
        nodes.append(N(i, {TYPES[t]: int(rng.randint(1, 5)) for t in picks}))
    cl = C(nodes)
    jobs = []
    for j in range(int(rng.randint(4, 30))):
        tp = {t: (0.0 if rng.rand() < 0.2 else float(rng.uniform(0.2, 4.0)))
              for t in cl.gpu_types}
        if not any(tp.values()):
            tp[cl.gpu_types[0]] = 1.0
        job = J(j, float(rng.choice([0.0, 10.0])), int(rng.randint(1, 7)),
                int(rng.randint(1, 50)), 10, tp)
        job.attained_service = float(rng.choice([0.0, 1000.0, 5000.0]))
        job.done_iters = float(rng.randint(0, 5))
        jobs.append(job)
    return jobs, cl


@pytest.mark.parametrize("seed", range(8))
def test_baseline_decisions_on_random_states_match_jax_package(seed):
    jjobs, jcl = _random_state((JCluster, JNode, JJob), seed)
    tjobs, tcl = _random_state((Cluster, Node, Job), seed)
    assert np.array_equal(
        tsched.GavelScheduler.allocation_matrix(tjobs, tcl),
        jsched.GavelScheduler.allocation_matrix(jjobs, jcl))
    for name in NAMES:
        jsch, tsch = getattr(jsched, name)(), getattr(tsched, name)()
        for now in (0.0, 10.0, 10.0):     # Gavel's rounds_received carry
            want = jsch.schedule(now, 360.0, jjobs, jcl)
            got = tsch.schedule(now, 360.0, tjobs, tcl)
            assert got == want
    assert tsch.stable_when_idle and not tsch.preemptive


def test_baseline_flags_match_jax_package():
    for name in NAMES:
        j, t = getattr(jsched, name), getattr(tsched, name)
        assert (t.name, t.preemptive, t.stable_when_idle) == \
            (j.name, j.preemptive, j.stable_when_idle)
    assert tsched.TiresiasScheduler().threshold == \
        jsched.TiresiasScheduler().threshold

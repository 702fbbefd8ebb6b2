"""The port's Hadar decision path against the JAX package's, on the CPU.

- The plain versions of kernels K4 (``ref.find_alloc_ref``) and K5
  (``ref.commit_scan_ref``) against the JAX kernels they replace
  (``_build_kernel`` and ``_build_commit_kernel`` of
  ``repro.core.batch_solver``) on the same host tables, bitwise.  The JAX
  package switches its batched solver off where ``jax.experimental`` has
  no ``enable_x64`` (its ``HAS_JAX``); these tests bind the module's
  ``jax``/``jnp`` names for their own duration and run the kernels under
  ``jax.enable_x64``.
- ``HadarScheduler(solver="numpy")`` and the port's ``simulate`` against
  the JAX package's NumPy path on fig5 traces.  The reference scheduler is
  constructed here with ``solver="numpy"``; no ``solver=`` goes to the
  reference engines.
- The port's batched path (``solver="cuda"``) with ``device="cpu"``, where
  its kernels' plain versions run, against its NumPy oracle.
- Solver names and the device rule: ``cuda`` raises without CUDA.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch_solver as jbs
from repro.core import trace as jtrace
from repro.core.dp import dp_allocation as jdp_allocation
from repro.core.hadar import HadarScheduler as JHadar
from repro.core.pricing import PriceState as JPriceState
from repro.core.simulator import simulate as jsimulate
from repro_torch.core import batch_solver as tbs
from repro_torch.core import trace as ttrace
from repro_torch.core.dp import COMM_COST_FRAC, _find_alloc_arrays
from repro_torch.core.dp import dp_allocation as tdp_allocation
from repro_torch.core.hadar import HadarScheduler
from repro_torch.core.pricing import PriceState
from repro_torch.core.simulator import simulate
from repro_torch.core.types import Cluster, Job, Node, clone_jobs
from repro_torch.core.utility import effective_throughput
from repro_torch.kernels import commit_scan as tcommit
from repro_torch.kernels import find_alloc as tfind
from repro_torch.kernels import ops, ref
from repro_torch.sim.engine import simulate_rounds

HORIZON = 7 * 24 * 3600.0
TYPES = ["v100", "p100", "k80", "t4"]


def _fig5(pkg, n, topo):
    """(jobs, cluster, now) of the fig5 scalability round from ``pkg``'s
    own trace module (``benchmarks/fig5_scalability.py``)."""
    if topo == "grown":
        n_nodes = max(15, n // 8)
        kinds = ["v100", "p100", "k80"]
        node = jtrace.Node if pkg is jtrace else Node
        cl = (jtrace.Cluster if pkg is jtrace else Cluster)(
            [node(i, {kinds[i % 3]: 4}) for i in range(n_nodes)])
        return pkg.philly_trace(n_jobs=n, seed=1, types=cl.gpu_types), cl, 0.0
    cl = pkg.multi_cluster(n_pods=3, nodes_per_pod=max(5, n // 24),
                           gpus_per_node=4, pod_types=["v100", "p100", "k80"],
                           mixed_frac=0.25, seed=2)
    jobs = pkg.philly_trace(n_jobs=n, seed=1, types=cl.gpu_types,
                            arrival_pattern="bursty")
    return jobs, cl, max(j.arrival for j in jobs)


def _decided(cands):
    return {jid: (sorted(c.alloc.items()), c.cost, c.payoff, c.rate)
            for jid, c in cands.items()}


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package's batch-solver kernels, built under x64."""
    monkeypatch.setattr(jbs, "jax", jax)
    monkeypatch.setattr(jbs, "jnp", jnp)
    return jbs


def _state(n, topo):
    """A fig5 round's reference PriceState with a few units committed."""
    jobs, cl, now = _fig5(jtrace, n, topo)
    ps = JPriceState(cl, jobs, HORIZON, now=now)
    avail, gamma = ps.free_arr.copy(), ps.gamma_arr.copy()
    for m in range(0, len(avail), 3):
        avail[m] -= 1
        gamma[m] += 1
    return jobs, ps, now, avail, gamma


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(
        a if dtype is None else a.astype(dtype)))


# ---------------------------------------------------------------------------
# K4 and K5: plain versions against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,topo", [(64, "grown"), (200, "bursty"),
                                    (130, "grown")])
def test_find_alloc_ref_matches_jax_kernel(jax_kernels, n, topo):
    jobs, ps, now, avail, gamma = _state(n, topo)
    B = jbs.bucket_size(len(jobs))
    M, N, R = len(ps.keys), ps.n_node_rows, len(ps.cluster.gpu_types)
    C = int(max(ps.cap_arr.max(), avail.max(), 1.0))
    jt = jbs._job_tables(jobs, ps, now, ps.utility, B)
    P = ps.unit_prices(gamma, C)
    cumP = np.zeros((M, C + 1))
    np.cumsum(P, axis=1, out=cumP[:, 1:])
    valid = jt.usable[:, :, None] & (np.arange(C)[None, :] < avail[:, None])
    ratio = np.where(valid, P[None] / jt.x_key[:, :, None], np.inf)
    order = np.argsort(ratio.reshape(B, -1), axis=-1, kind="stable")
    s_rank = np.take_along_axis(np.repeat(jt.rank, C, axis=1), order, -1)
    s_valid = np.take_along_axis(valid.reshape(B, -1), order, -1)
    s_price = P.reshape(-1)[order]
    with jax.enable_x64():
        want = jbs._build_kernel(N, R, COMM_COST_FRAC)(
            *map(jnp.asarray, (
                avail, P, cumP, ps.node_row, jt.W, jt.Kj, jt.rank, jt.u_tab,
                jt.single, s_rank, s_valid, s_price,
                np.take_along_axis(ratio.reshape(B, -1), order, -1), order,
                ratio)))
        want = [np.asarray(w) for w in want]
    got = ref.find_alloc_ref(
        _t(avail), _t(cumP), _t(ps.node_row, np.int32), _t(jt.W),
        _t(jt.Kj, np.int32), _t(jt.single), _t(jt.rank, np.int32),
        _t(jt.u_tab), _t(s_rank, np.int32), _t(s_valid), _t(s_price),
        _t(order // C, np.int32), N, COMM_COST_FRAC, tbs._wmax(jt.W))
    assert sum(int(w.sum()) for w in want[:1]) > 0   # some feasible slots
    for w, g in zip(want, got):
        assert np.array_equal(w.astype(g.numpy().dtype), g.numpy())


@pytest.mark.parametrize("n,topo", [(64, "bursty"), (200, "grown")])
def test_commit_scan_ref_matches_jax_kernel(jax_kernels, n, topo):
    jobs, ps, now, avail, gamma = _state(n, topo)
    J, M, N = len(jobs), len(ps.keys), ps.n_node_rows
    R = len(ps.cluster.gpu_types)
    C = int(max(ps.cap_arr.max(), (gamma + avail).max(), 1.0))
    B = jbs.bucket_size(J)
    jt = jbs._job_tables(jobs, ps, now, ps.utility, B)
    P_tab = ps.unit_prices(np.zeros(M), C)
    ratio = np.where(jt.usable[:, :, None],
                     P_tab[None] / jt.x_key[:, :, None], np.inf)
    order = np.argsort(ratio.reshape(B, -1), axis=-1, kind="stable")
    s_m = (order // C).astype(np.int32)
    s_u = (order % C).astype(np.int32)
    s_rank = np.take_along_axis(jt.rank, s_m, axis=1).astype(np.int32)
    s_price = P_tab.reshape(-1)[order]
    s_node = ps.node_row[s_m].astype(np.int32)
    wmax = tbs._wmax(jt.W)
    with jax.enable_x64():
        want = jbs._build_commit_kernel(N, R, COMM_COST_FRAC, wmax)(
            *map(jnp.asarray, (
                avail, gamma.astype(np.int32), P_tab, ps.node_row, jt.W,
                jt.W.astype(np.int32), jt.Kj.astype(np.int32), jt.single,
                jt.rank.astype(np.int32), jt.u_tab, s_m, s_u, s_rank,
                s_price, s_node)))
        want = [np.asarray(w) for w in want]
    got = ref.commit_scan_ref(
        _t(avail), _t(gamma, np.int32), _t(P_tab), _t(ps.node_row, np.int32),
        _t(jt.W), _t(jt.Kj, np.int32), _t(jt.single),
        _t(jt.rank, np.int32), _t(jt.u_tab), _t(s_m), _t(s_u), _t(s_rank),
        _t(s_price), _t(s_node), N, COMM_COST_FRAC, wmax)
    assert want[2].any()                             # some winners
    for w, g in zip(want, got):
        assert np.array_equal(w.astype(g.numpy().dtype), g.numpy())


def test_pairwise_sum_is_numpys_order():
    rs = np.random.RandomState(0)
    v = rs.uniform(0, 1, (500, 128)) * 10.0 ** rs.uniform(-3, 3, (500, 128))
    n = rs.randint(0, 129, 500)
    got = ref.pairwise_sum(torch.from_numpy(v), torch.from_numpy(n)).numpy()
    want = np.array([v[i, :n[i]].sum() for i in range(500)])
    assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        ref.pairwise_sum(torch.zeros(2, 129), torch.ones(2, dtype=torch.long))


def test_kernel_wrappers_reject_cpu_tensors():
    jobs, cl, now = _fig5(ttrace, 16, "grown")
    ps = PriceState(cl, jobs, HORIZON, now=now)
    tab = tbs.pricing_tables(jobs, ps.free_arr, ps.gamma_arr, ps, now,
                             effective_throughput, tbs.bucket_size(16))
    args = [_t(tab[k]) for k in tbs.FIND_ALLOC_ARGS]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tfind.find_alloc(*args, tab["n_nodes"], COMM_COST_FRAC, tab["wmax"])
    with pytest.raises(ValueError, match="exceeds wmax"):
        tfind.check_wmax("find_alloc", _t(np.array([9.0])), 8)
    stab = tbs.scan_tables(jobs, ps.free_arr, ps.gamma_arr, ps, now,
                           effective_throughput, tbs.bucket_size(16))
    sargs = [_t(stab[k]) for k in tbs.COMMIT_SCAN_ARGS]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tcommit.commit_scan(*sargs, stab["n_nodes"], COMM_COST_FRAC,
                            stab["wmax"])
    # ops sends CPU tensors to the plain versions
    assert len(ops.find_alloc(*args, n_nodes=tab["n_nodes"],
                              comm_frac=COMM_COST_FRAC,
                              wmax=tab["wmax"])) == 11


# ---------------------------------------------------------------------------
# the NumPy path against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,topo,arrived", [
    (32, "grown", None), (64, "bursty", None), (130, "grown", None),
    (130, "bursty", None), (32, "bursty", 16), (64, "bursty", 22)])
def test_numpy_decisions_match_jax_package(n, topo, arrived):
    """One Hadar round: after every arrival (the greedy pass), or at the
    ``arrived``-th arrival of the bursty trace, where the queue fits the
    exact DP (max_exact_dp 24).  The same allocations, and
    dp_allocation's candidates with the same cost, payoff and rate."""
    jjobs, jcl, now = _fig5(jtrace, n, topo)
    tjobs, tcl, _ = _fig5(ttrace, n, topo)
    if arrived is not None:
        now = sorted(j.arrival for j in jjobs)[arrived - 1]
    want = JHadar(solver="numpy").schedule(now, 360.0, jjobs, jcl)
    got = HadarScheduler(solver="numpy").schedule(now, 360.0, tjobs, tcl)
    max_exact = 24
    assert got == want and len(got) > 0
    queue = sorted([j for j in jjobs if j.arrival <= now],
                   key=lambda j: (j.arrival, j.job_id))
    tqueue = sorted([j for j in tjobs if j.arrival <= now],
                    key=lambda j: (j.arrival, j.job_id))
    jps = JPriceState(jcl, queue, HORIZON, now=now)
    tps = PriceState(tcl, tqueue, HORIZON, now=now)
    jsel = jdp_allocation(queue, None, jps, now, effective_throughput,
                          max_exact=max_exact, solver="numpy")
    tsel = tdp_allocation(tqueue, None, tps, now, effective_throughput,
                          max_exact=max_exact, solver="numpy")
    assert _decided(tsel) == _decided(jsel)


def _round_record(r):
    return dataclasses.replace(r, sched_seconds=0.0)


def test_simulate_matches_jax_package():
    jjobs, jcl, _ = _fig5(jtrace, 48, "grown")
    tjobs, tcl, _ = _fig5(ttrace, 48, "grown")
    want = jsimulate(JHadar(solver="numpy"), jjobs, jcl)
    got = simulate(HadarScheduler(solver="numpy"), tjobs, tcl)
    assert got.avg_jct() == want.avg_jct()
    assert got.total_seconds == want.total_seconds
    assert [j.finish_time for j in got.jobs] == \
        [j.finish_time for j in want.jobs]
    assert [dataclasses.astuple(_round_record(r)) for r in got.rounds] == \
        [dataclasses.astuple(_round_record(r)) for r in want.rounds]
    assert got.gru_overall() == want.gru_overall()


# ---------------------------------------------------------------------------
# the batched path (plain versions on the CPU) against the NumPy oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,topo", [(64, "grown"), (130, "bursty"),
                                    (256, "grown")])
def test_batched_round_matches_numpy(n, topo):
    jobs, cl, now = _fig5(ttrace, n, topo)
    want = HadarScheduler(solver="numpy")
    got = HadarScheduler(solver="cuda", device="cpu")
    assert got.schedule(now, 360.0, clone_jobs(jobs), cl) == \
        want.schedule(now, 360.0, clone_jobs(jobs), cl)
    assert _decided(got.last_decisions) == _decided(want.last_decisions)


def _random_cluster(rng) -> Cluster:
    nodes = []
    for i in range(int(rng.randint(3, 7))):
        picks = rng.choice(len(TYPES), size=int(rng.randint(1, 3)),
                           replace=False)
        nodes.append(Node(i, {TYPES[t]: int(rng.randint(1, 5))
                              for t in picks}))
    return Cluster(nodes)


def _random_jobs(cluster, rng, n):
    """Zero-throughput types, single-node copies and large gangs: the
    padding and eligibility edges of the batched path."""
    jobs = []
    for j in range(n):
        tp = {t: (0.0 if rng.rand() < 0.2 else float(rng.uniform(0.2, 4.0)))
              for t in cluster.gpu_types}
        if not any(tp.values()):
            tp[cluster.gpu_types[0]] = 1.0
        jobs.append(Job(j, 0.0, int(rng.randint(1, 7)),
                        int(rng.randint(1, 50)), 10, tp,
                        single_node=bool(rng.rand() < 0.25)))
    return jobs


@pytest.mark.parametrize("seed", range(6))
def test_batched_paths_match_numpy_on_random_geometry(seed):
    rng = np.random.RandomState(seed)
    cl = _random_cluster(rng)
    jobs = _random_jobs(cl, rng, int(rng.randint(5, 40)))
    ps = PriceState(cl, jobs, HORIZON, device="cpu")
    avail, gamma = ps.free_arr.copy(), ps.gamma_arr.copy()
    batch = tbs.find_alloc_batch(jobs, avail, gamma, ps, 0.0,
                                 effective_throughput)
    for job, cand in zip(jobs, batch):
        one = _find_alloc_arrays(job, avail, gamma, ps, 0.0,
                                 effective_throughput, False)
        assert (cand is None) == (one is None)
        if one is not None:
            assert _decided({0: cand}) == _decided({0: one})
    want = tdp_allocation(jobs, None, ps, 0.0, effective_throughput,
                          max_exact=0, solver="numpy")
    got = tdp_allocation(jobs, None, ps, 0.0, effective_throughput,
                         max_exact=0, solver="cuda")
    assert _decided(got) == _decided(want)


def test_scan_commit_carry_and_winners_match_numpy():
    """The whole greedy order through K5's plain version: the winners of
    the sequential NumPy loop, and the carry the host applies."""
    jobs, cl, now = _fig5(ttrace, 130, "bursty")
    ps = PriceState(cl, jobs, HORIZON, now=now, device="cpu")
    avail, gamma = ps.free_arr.copy(), ps.gamma_arr.copy()
    cands = [_find_alloc_arrays(j, avail, gamma, ps, now,
                                effective_throughput, False) for j in jobs]
    order = [j for _, j in sorted(
        ((c.payoff / max(1, j.n_workers), j) for j, c in zip(jobs, cands)
         if c), key=lambda t: -t[0])]
    a1, g1 = avail.copy(), gamma.copy()
    want = {}
    for j in order:
        c = _find_alloc_arrays(j, a1, g1, ps, now, effective_throughput,
                               False)
        if c:
            want[j.job_id] = c
            for k, v in c.alloc.items():
                a1[ps.key_index[k]] -= v
                g1[ps.key_index[k]] += v
    a2, g2 = avail.copy(), gamma.copy()
    got = tbs._scan_commit(order, a2, g2, ps, now, effective_throughput)
    assert _decided(got) == _decided(want) and len(want) > 0
    assert np.array_equal(a1, a2) and np.array_equal(g1, g2)


def test_batched_simulate_matches_numpy():
    jobs, cl, _ = _fig5(ttrace, 40, "grown")
    want = simulate(HadarScheduler(solver="numpy"), clone_jobs(jobs), cl)
    got = simulate(HadarScheduler(solver="cuda", device="cpu"),
                   clone_jobs(jobs), cl)
    assert got.avg_jct() == want.avg_jct()
    assert [j.finish_time for j in got.jobs] == \
        [j.finish_time for j in want.jobs]


# ---------------------------------------------------------------------------
# solvers and devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", ["jax", "tpu", "CUDA", "gpu"])
def test_check_solver_rejects_unknown_names(bad):
    with pytest.raises(ValueError, match="unknown solver"):
        tbs.check_solver(bad)
    with pytest.raises(ValueError, match="unknown solver"):
        HadarScheduler(solver=bad)
    jobs, cl, _ = _fig5(ttrace, 4, "grown")
    with pytest.raises(ValueError, match="unknown solver"):
        simulate_rounds(HadarScheduler(solver="numpy"), jobs, cl,
                        solver=bad)


def test_cuda_solver_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HadarScheduler(solver="cuda")
    sched = HadarScheduler(solver="numpy")
    jobs, cl, now = _fig5(ttrace, 32, "grown")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate_rounds(sched, jobs, cl, solver="cuda")
    # auto never takes the plain versions: NumPy without a card
    assert tbs.resolve_backend("auto", 10_000) == "numpy"
    assert not tbs.use_commit("auto", 10_000)
    assert tbs.resolve_backend("cuda", 10, device="cpu") == "cuda"


def test_device_view_caches_until_dirty():
    jobs, cl, _ = _fig5(ttrace, 16, "bursty")
    ps = PriceState(cl, jobs, HORIZON, device="cpu")
    v1 = ps.device_view("free")
    assert v1 is ps.device_view("free")
    assert v1.dtype == torch.float64
    assert ps.device_view("node_row").dtype == torch.int32
    ps.commit({ps.keys[0]: 1})
    v3 = ps.device_view("free")
    assert v3 is not v1 and np.array_equal(v3.numpy(), ps.free_arr)
    ps.gamma[ps.keys[1]] = 2
    assert ps.device_view("gamma")[1] == 2.0
    with pytest.raises(KeyError):
        ps.device_view("nope")


def test_trace_copies_match_jax_package():
    for n, topo in ((64, "grown"), (64, "bursty")):
        jjobs, jcl, jnow = _fig5(jtrace, n, topo)
        tjobs, tcl, tnow = _fig5(ttrace, n, topo)
        assert jnow == tnow
        assert [dataclasses.astuple(j) for j in jjobs] == \
            [dataclasses.astuple(j) for j in tjobs]
        assert [(n_.node_id, n_.gpus, n_.pcie_scaling) for n_ in jcl.nodes] \
            == [(n_.node_id, n_.gpus, n_.pcie_scaling) for n_ in tcl.nodes]
    assert ttrace.grown_cluster(200).total_gpus() == 100

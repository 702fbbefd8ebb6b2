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
import importlib.util
from pathlib import Path

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


def _add_free(avail, delta):
    """``avail`` with ``delta`` added to every third key's free units
    (where at least one is free when ``delta`` is negative)."""
    avail = avail.copy()
    keys = np.arange(0, len(avail), 3)
    if delta < 0:
        keys = keys[avail[keys] >= 1.0]
    avail[keys] += delta
    return avail


def _scan_inputs(n, topo, delta=0.0):
    """K5's host tables at ``_state(n, topo)`` (with ``_add_free(delta)``),
    built as the JAX package's ``_scan_commit`` builds them: (the tables
    by ``ops.commit_scan``'s argument names, N, R, C, wmax)."""
    jobs, ps, now, avail, gamma = _state(n, topo)
    avail = _add_free(avail, delta)
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
    tab = {"free": avail, "gamma": gamma.astype(np.int32), "P_tab": P_tab,
           "node_row": ps.node_row.astype(np.int32), "W": jt.W,
           "Kj": jt.Kj.astype(np.int32), "single": jt.single,
           "rank": jt.rank.astype(np.int32), "u_tab": jt.u_tab, "s_m": s_m,
           "s_u": (order % C).astype(np.int32),
           "s_rank": np.take_along_axis(jt.rank, s_m,
                                        axis=1).astype(np.int32),
           "s_price": P_tab.reshape(-1)[order],
           "s_node": ps.node_row[s_m].astype(np.int32)}
    return tab, N, R, C, tbs._wmax(jt.W)


def _jax_commit(tab, N, R, wmax):
    """The JAX package's K5 (``_build_commit_kernel``) on ``tab``."""
    with jax.enable_x64():
        want = jbs._build_commit_kernel(N, R, COMM_COST_FRAC, wmax)(
            *map(jnp.asarray, (
                tab["free"], tab["gamma"], tab["P_tab"], tab["node_row"],
                tab["W"], tab["W"].astype(np.int32), tab["Kj"],
                tab["single"], tab["rank"], tab["u_tab"], tab["s_m"],
                tab["s_u"], tab["s_rank"], tab["s_price"], tab["s_node"])))
        return [np.asarray(w) for w in want]


def _ref_commit(tab, N, wmax, need=None):
    return ref.commit_scan_ref(*(_t(tab[k]) for k in tbs.COMMIT_SCAN_ARGS),
                               N, COMM_COST_FRAC, wmax, need=need)


# the last two: a fractional carry.  +0.5 pushes a key's window past the
# last unit (gamma + free = C + 0.5), where it is cut; -0.5 leaves
# ceil(free) units inside it.
FRAC_STATES = [pytest.param(64, "bursty", 0.0, id="64-bursty"),
               pytest.param(200, "grown", 0.0, id="200-grown"),
               pytest.param(64, "bursty", 0.5, id="64-bursty-free+0.5"),
               pytest.param(200, "grown", -0.5, id="200-grown-free-0.5")]


@pytest.mark.parametrize("n,topo,delta", FRAC_STATES)
def test_commit_scan_ref_matches_jax_kernel(jax_kernels, n, topo, delta):
    tab, N, R, _, wmax = _scan_inputs(n, topo, delta)
    assert delta == 0.0 or not np.array_equal(tab["free"],
                                              np.round(tab["free"]))
    want = _jax_commit(tab, N, R, wmax)
    got = _ref_commit(tab, N, wmax)
    assert want[2].any()                             # some winners
    for w, g in zip(want, got):
        assert np.array_equal(w.astype(g.numpy().dtype), g.numpy())


def _window_units(free, gamma, C):
    """Units u in [0, C) with gamma <= u < gamma + free, per key."""
    hi = np.minimum(C, gamma + np.ceil(free))
    return np.where(free > 0, np.maximum(hi - np.maximum(gamma, 0), 0),
                    0).astype(np.int64)


@pytest.mark.parametrize("n,topo,delta", FRAC_STATES)
def test_commit_scan_ref_count_identity(n, topo, delta):
    """K5's count before walking, on the plain version's outputs, with
    the carry replayed from its counts: every prefix's eligible units in
    the pool are the keys' window units; where they are fewer than W,
    sp_nserv is the number of node rows that hold one, and the step
    reads no pool entry for that prefix (``need``)."""
    tab, N, R, C, wmax = _scan_inputs(n, topo, delta)
    need = []
    _, _, _, _, counts, _, _, sp_nserv = _ref_commit(tab, N, wmax, need)
    counts, sp_nserv = counts.numpy(), sp_nserv.numpy()
    free = tab["free"].copy()
    gamma = tab["gamma"].astype(np.int64)
    counted = walked = 0
    for p in range(len(tab["W"])):
        w, kj, rank = int(tab["W"][p]), int(tab["Kj"][p]), tab["rank"][p]
        units = _window_units(free, gamma, C)
        m, u = tab["s_m"][p], tab["s_u"][p]
        inside = (u >= gamma[m]) & (u - gamma[m] < free[m])
        reach = 0
        for k in range(1, R + 1):
            mine = rank < k
            assert units[mine].sum() == (inside & (tab["s_rank"][p] < k)).sum()
            if kj == 0:
                continue
            if units[mine].sum() < w:
                counted += 1
                rows = np.unique(tab["node_row"][mine & (units > 0)])
                assert sp_nserv[p, k - 1] == rows.size
            else:
                walked += 1
                reach = max(reach, 1 + np.nonzero(np.cumsum(
                    inside & (tab["s_rank"][p] < k)) >= w)[0][0])
        assert need[p][0] == (reach if w and kj else 0)
        free = free - counts[p]
        gamma = gamma + counts[p]
    assert counted > 0 and walked > 0


def _smoke():
    """The repository's ``chip_smoke.py`` as a module (its table builders
    need no card)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _agrees_with_jax(tab, pay_ulps=0):
    """The plain version and the JAX package's K5 on ``tab``: bitwise, but
    for the runner-up payoff, which may differ by ``pay_ulps`` where the
    JAX kernel sums a spread slot's prices in XLA's order, not NumPy's
    (the reference's own caveat, ``repro/core/batch_solver.py:50-59``)."""
    N, R = tab["n_nodes"], tab["u_tab"].shape[1]
    want = _jax_commit(tab, N, R, tab["wmax"])
    got = [g.numpy() for g in _ref_commit(tab, N, tab["wmax"])]
    assert want[2].any()                             # some winners
    for i, (w, g) in enumerate(zip(want, got)):
        w = w.astype(g.dtype)
        if i == 6:  # win2_pay
            assert np.array_equal(np.isfinite(w), np.isfinite(g))
            ulps = np.abs(w.view(np.int64) - g.view(np.int64))
            assert np.all(np.where(np.isfinite(w), ulps, 0) <= pay_ulps)
        else:
            assert np.array_equal(w, g)


def _jax_find_alloc(tab):
    """The JAX package's K4 (``_build_kernel``) on tables that the port's
    ``pricing_tables`` built; the extra inputs the JAX kernel takes (the
    pool's ratios and their stable order) are rebuilt as ``pricing_tables``
    sorts them."""
    jt, P, C = tab["jt"], tab["P"], tab["C"]
    B = tab["rank"].shape[0]
    valid = jt.usable[:, :, None] \
        & (np.arange(C)[None, :] < tab["avail"][:, None])
    ratio = np.where(valid, P[None] / jt.x_key[:, :, None], np.inf)
    order = np.argsort(ratio.reshape(B, -1), axis=-1, kind="stable")
    assert np.array_equal(order // C, tab["s_key"])
    with jax.enable_x64():
        want = jbs._build_kernel(tab["n_nodes"], tab["u_tab"].shape[1],
                                 COMM_COST_FRAC)(*map(jnp.asarray, (
                                     tab["avail"], P, tab["cumP"],
                                     tab["node_row"], tab["W"], tab["Kj"],
                                     tab["rank"], tab["u_tab"], tab["single"],
                                     tab["s_rank"], tab["s_valid"],
                                     tab["s_price"],
                                     np.take_along_axis(
                                         ratio.reshape(B, -1), order, -1),
                                     order, ratio)))
        return [np.asarray(w) for w in want]


@pytest.mark.parametrize("kind,n", [("busy", 64), ("busy", 256),
                                    ("wide", 64), ("mixed", 120),
                                    ("queue", 96)])
def test_smoke_k4_tables(jax_kernels, kind, n):
    """``chip_smoke.k4_tables``: K4's further cases reach what each is
    for (walks past the pool's first chunk, prefixes short of W, a partial
    last chunk; gangs up to 128; mixed nodes, subsets of the types,
    single-node jobs, fractional free units; more jobs than node rows), and
    the plain version agrees with the JAX package's K4 on them bitwise."""
    smoke = _smoke()
    tab = smoke.k4_tables(kind, n)
    walks = smoke.walk_stats(tab)
    R, N = tab["u_tab"].shape[1], tab["n_nodes"]
    J = n
    assert (walks["past_chunk1"] > 0) == (kind != "queue")
    if kind == "queue":
        assert N == 32 and len(tab["W"]) >= J > N
    if kind == "busy":
        assert walks["short_of_W"] > 0
    if kind == "wide":
        assert tab["wmax"] == 128 and tab["W"][:J].min() >= 16
        assert (tab["W"][:J] % 8 != 0).any()
    if kind == "mixed":
        assert R >= 4 and N % 32 and walks["partial_chunk"] > 0
        assert (tab["Kj"][:J] < R).any() and tab["single"][:J].any()
        assert (tab["avail"] % 1.0 != 0).any()
        assert (np.bincount(tab["node_row"]) > 1).any()   # mixed nodes
    want = _jax_find_alloc(tab)
    got = ref.find_alloc_ref(*(_t(tab[k]) for k in tbs.FIND_ALLOC_ARGS), N,
                             COMM_COST_FRAC, tab["wmax"])
    assert want[6].any()                     # spread slots
    assert want[0].any() == (kind != "wide")  # gangs of 16+ fit no node
    for w, g in zip(want, got):
        assert np.array_equal(w.astype(g.numpy().dtype), g.numpy())


@pytest.mark.parametrize("n", [8, 16])
def test_smoke_hadare_tables(jax_kernels, n):
    """``chip_smoke.hadare_tables``: the first greedy consult of the smoke's
    HadarE run (here with the kernels' plain versions) queues every
    parent's copies, all single-node, a parent's copies in equal rows (the
    queue is in job-id order, so copy i of every parent comes before copy
    i + 1 of any); the plain K4 and K5 agree with the JAX package's
    kernels bitwise on them."""
    from repro_torch.core.trace import grown_cluster
    k4, k5 = _smoke().hadare_tables(n, device="cpu")
    C = len(grown_cluster(n).nodes)
    J = n * C
    assert len(k4["W"]) >= J and (k4["W"][:J] > 0).all()
    assert not k4["W"][J:].any() and k4["single"][:J].all()
    for key in ("W", "Kj", "rank", "u_tab", "s_rank", "s_price", "s_key"):
        rows = np.asarray(k4[key][:J]).reshape(C, n, -1)
        assert (rows == rows[:1]).all(), key
    assert k5["single"][:int((k5["W"] > 0).sum())].all()
    want = _jax_find_alloc(k4)
    got = ref.find_alloc_ref(*(_t(k4[k]) for k in tbs.FIND_ALLOC_ARGS),
                             k4["n_nodes"], COMM_COST_FRAC, k4["wmax"])
    for w, g in zip(want, got):
        assert np.array_equal(w.astype(g.numpy().dtype), g.numpy())
    _agrees_with_jax(k5)


@pytest.mark.parametrize("delta", [0.5, -0.5])
def test_smoke_frac_tables(jax_kernels, delta):
    """``chip_smoke.frac_tables``: the fig5 K5 tables with ``delta`` on
    every third key's free (only the free vector changes), on which the
    plain version agrees with the JAX package's K5."""
    smoke = _smoke()
    base = smoke.sched_tables(64, "grown")[1]
    tab = smoke.frac_tables(delta, n=64, topo="grown")
    keys = np.arange(0, len(base["free"]), 3)
    if delta < 0:
        keys = keys[base["free"][keys] >= 1.0]
    want_free = base["free"].copy()
    want_free[keys] += delta
    assert keys.size and np.array_equal(tab["free"], want_free)
    for k in base:
        if k not in ("free", "jt"):
            assert np.array_equal(np.asarray(tab[k]), np.asarray(base[k]))
    _agrees_with_jax(tab)


@pytest.mark.parametrize("kind,n_nodes", [("random", 12), ("random", 30),
                                          ("cut", 12)])
def test_smoke_random_tables(jax_kernels, kind, n_nodes):
    """``chip_smoke.random_tables`` (and its "cut" form) keeps
    ``scan_tables``' invariants (each pool the whole (key, unit) table,
    s_rank = rank[s_m], s_node = node_row[s_m], one key per (node row,
    type)), and the plain version agrees with the JAX package's K5 on it,
    jobs that ask for no unit included: every decision bitwise, the
    runner-up payoff within 2 ulps (spread slots of up to 8 units, which
    the JAX kernel sums in XLA's order)."""
    tab = _smoke().extra_tables(kind, n_nodes)
    assert (tab["W"] == 0).any()
    if kind == "cut":
        assert np.all(tab["free"] == 1.5)
    M, C = len(tab["free"]), tab["C"]
    flat = tab["s_m"].astype(np.int64) * C + tab["s_u"]
    assert np.array_equal(np.sort(flat, axis=1),
                          np.broadcast_to(np.arange(M * C), flat.shape))
    assert np.array_equal(tab["s_rank"],
                          np.take_along_axis(tab["rank"], tab["s_m"], 1))
    assert np.array_equal(tab["s_node"], tab["node_row"][tab["s_m"]])
    assert np.array_equal(tab["s_price"],
                          tab["P_tab"].reshape(-1)[flat])
    cells = tab["node_row"][None, :] * (tab["u_tab"].shape[1] + 1) \
        + tab["rank"]
    usable = tab["rank"] < tab["Kj"][:, None]
    assert all(len(set(c[u])) == u.sum() for c, u in zip(cells, usable))
    _agrees_with_jax(tab, pay_ulps=2)


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

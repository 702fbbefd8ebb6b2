"""The batched dual price solver on the card: FIND_ALLOC for the whole
queue in one launch of kernel K4, and the greedy commit through
conflict-free waves and one launch of kernel K5.

The port's copy of the host side of ``repro.core.batch_solver``, with the
two device kernels written by hand (``repro_torch.kernels.find_alloc``
and ``commit_scan``) in place of the JAX ``vmap`` and ``lax.scan``.

Tensor axes:

==========  =============================================================
axis        meaning
==========  =============================================================
``B``       padded job bucket (queue axis; line 13's loop over the queue)
``M``       cluster *keys* — one per (node, gpu_type) pair, in
            ``PriceState.keys`` order
``N``       node rows (line 24's "each server h")
``R``       global GPU types; per job, column ``k`` is the rank in the
            job's throughput-descending preference order (``rank == R``
            marks a type the job cannot use)
``C``       marginal units per key, unit ``i`` = the (i+1)-th extra
            device (Eq. 5's gamma+i exponent)
``L``       the (key, unit) pool, M * C, in each job's stable sort order
==========  =============================================================

Decision fidelity: the unit prices ``P``, their prefix sums, the utility
table and the stable sort of the spread pool are computed on the host
with the NumPy operations of the per-job path, so every float the
kernels compare is bitwise the oracle's.  The kernels sum in the
oracle's order too (sequential unit prefix sums; NumPy's pairwise
summation over ranks and over a spread candidate's chosen units), so
their candidate payoffs are bitwise those of
``repro_torch.core.dp._find_alloc_arrays``.  Each winner's emitted
cost/payoff/rate is re-derived on the host as in the JAX package.

Solvers: ``numpy`` (the per-job oracle), ``cuda`` (the kernels; raises
``RuntimeError`` where CUDA is absent unless the PriceState's device is
the CPU, where the kernels' plain versions run — the tests' path) and
``auto`` (the card when there is one and the queue clears the crossover;
the JAX package's fallback constants, not yet calibrated on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.utility import effective_throughput
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

# Crossovers of the ``auto`` solver (the JAX package's fallback
# constants): queues below the pricing threshold stay on the per-job
# NumPy path, greedy queues below the commit threshold keep the
# sequential NumPy commit.  ``cuda`` takes the card at any size.
AUTO_MIN_JOBS = 16
COMMIT_MIN_JOBS = 96
_BUCKET_MIN = 8
SOLVERS = ("numpy", "cuda", "auto")


def check_solver(solver: Optional[str]) -> str:
    """Validate a ``solver`` name (None means ``auto``)."""
    mode = solver or "auto"
    if mode not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r} "
                         "(expected 'numpy', 'cuda', or 'auto')")
    return mode


def _card_usable(device: DeviceLike) -> bool:
    """Would ``device`` (None: the card) run the kernels?  The CPU never
    does under ``auto``: there it would run the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cuda" and torch.cuda.is_available()


def resolve_backend(solver: Optional[str], n_jobs: int,
                    device: DeviceLike = None) -> str:
    """The backend a queue of ``n_jobs`` runs on: ``"cuda"`` or
    ``"numpy"``.  ``cuda`` raises ``RuntimeError`` where CUDA is absent
    and ``device`` is not the CPU; ``auto`` applies the crossover."""
    mode = check_solver(solver)
    if mode == "auto":
        return ("cuda" if _card_usable(device) and n_jobs >= AUTO_MIN_JOBS
                else "numpy")
    if mode == "cuda":
        resolve_device(device)
    return mode


def use_batch(solver: Optional[str], n_jobs: int,
              device: DeviceLike = None) -> bool:
    """Should this call price the queue with K4?  Purely a performance
    dispatch — both paths return bit-identical decisions."""
    return n_jobs > 0 and resolve_backend(solver, n_jobs, device) == "cuda"


def use_commit(solver: Optional[str], n_jobs: int,
               device: DeviceLike = None) -> bool:
    """Should ``dp_allocation``'s greedy pass take the wave + K5 commit
    path?  Calibrated separately from the pricing threshold."""
    mode = check_solver(solver)
    if mode == "auto":
        return _card_usable(device) and n_jobs >= COMMIT_MIN_JOBS
    return n_jobs > 0 and resolve_backend(mode, n_jobs, device) == "cuda"


def bucket_size(n_jobs: int) -> int:
    """Pad the job axis to the next power of two (>= 8), as the JAX
    package does; padded rows are inert (W=0, Kj=0)."""
    b = _BUCKET_MIN
    while b < n_jobs:
        b *= 2
    return b


def _wmax(W: np.ndarray) -> int:
    """Width of a chosen spread set: the largest gang, rounded up to a
    power of two (min 8)."""
    return int(max(8, 1 << (int(W.max(initial=1.0)) - 1).bit_length()))


def _to(dev: torch.device, *arrays: np.ndarray):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@dataclasses.dataclass
class _JobTables:
    """Per-job host gather tables shared by K4 and K5 (identical scalar
    math — Eq. 1b/line 23)."""

    W: np.ndarray          # (B,) gang sizes (float, integer-valued)
    single: np.ndarray     # (B,) single-node flag
    Kj: np.ndarray         # (B,) usable-type count
    pref: np.ndarray       # (B, R) preference order over global types
    x_sorted: np.ndarray   # (B, R) throughput per preference rank
    u_tab: np.ndarray      # (B, R) U_j per preference rank
    rank: np.ndarray       # (B, M) preference rank of each key's type
    usable: np.ndarray     # (B, M)
    x_key: np.ndarray      # (B, M) throughput per key (1.0 if unusable)


def _job_tables(jobs: List, ps, now: float, utility,
                B: int) -> _JobTables:
    """Build the per-job tables on the host with the exact per-job-path
    scalar operations; rows at or beyond ``len(jobs)`` are inert padding
    (W=0, Kj=0)."""
    gtypes = ps.cluster.gpu_types
    J = len(jobs)
    R = len(gtypes)
    W = np.zeros(B)
    W[:J] = [j.n_workers for j in jobs]
    single = np.ones(B, dtype=bool)       # padded rows: no spread
    single[:J] = [bool(j.single_node) for j in jobs]
    tp = np.zeros((B, R))
    tp[:J] = [[j.throughput.get(r, 0) for r in gtypes] for j in jobs]
    usable_t = tp > 0
    Kj = usable_t.sum(axis=1)
    # preference order: throughput descending, gpu_types-order tiebreak —
    # a stable argsort on -tp reproduces the reference's sorted() exactly
    pref = np.argsort(-tp, axis=1, kind="stable")       # (B, R)
    x_sorted = np.take_along_axis(tp, pref, axis=1)
    kk = np.arange(R)
    x_sorted = np.where(kk[None, :] < Kj[:, None], x_sorted, 0.0)
    rank_t = np.empty((B, R), dtype=np.int64)
    np.put_along_axis(rank_t, pref, np.broadcast_to(kk, (B, R)), axis=1)
    rank_t = np.where(usable_t, rank_t, R)              # R == unusable
    rem = np.zeros(B)
    rem[:J] = [j.remaining_iters for j in jobs]
    arrival = np.zeros(B)
    arrival[:J] = [j.arrival for j in jobs]
    x_safe = np.where(kk[None, :] < Kj[:, None], x_sorted, 1.0)
    ct = np.maximum(now + rem[:, None] / (x_safe * np.maximum(W, 1.0)
                                          [:, None]) - arrival[:, None],
                    1e-9)
    if utility is effective_throughput:
        # the default utility vectorizes bitwise: total_iters / max(., .)
        tot = np.zeros(B)
        tot[:J] = [j.total_iters for j in jobs]
        u_tab = tot[:, None] / np.maximum(ct, 1e-9)
    else:
        u_tab = np.zeros((B, R))
        for ji, job in enumerate(jobs):
            for k in range(int(Kj[ji])):
                u_tab[ji, k] = utility(job, float(ct[ji, k]))
    u_tab = np.where(kk[None, :] < Kj[:, None], u_tab, 0.0)
    rank = rank_t[:, ps.type_col]                       # (B, M)
    usable = rank < Kj[:, None]
    x_key = np.where(
        usable,
        x_sorted[np.arange(B)[:, None], np.minimum(rank, R - 1)], 1.0)
    return _JobTables(W=W, single=single, Kj=Kj, pref=pref,
                      x_sorted=x_sorted, u_tab=u_tab, rank=rank,
                      usable=usable, x_key=x_key)


@dataclasses.dataclass
class BatchDetails:
    """Host-side solver state exported by ``find_alloc_batch`` for the
    conflict-free wave partitioner.  All job-axis arrays are sliced to
    the live (unpadded) queue."""

    avail0: np.ndarray        # (M,) free units at solve time (copy)
    cumP: np.ndarray          # (M, C+1) Eq. 5 unit-price prefix sums
    u_tab: np.ndarray         # (J, R) utility per preference rank
    rank: np.ndarray          # (J, M) preference rank of each key's type
    usable: np.ndarray        # (J, M) rank < Kj
    Kj: np.ndarray            # (J,) usable-type count
    single: np.ndarray        # (J,) single-node flag (no spread slots)
    feasible: np.ndarray      # (J, N) consolidated slot feasible
    k_first: np.ndarray       # (J, N) first feasible preference prefix-1
    packed_payoff: np.ndarray  # (J, N)
    sp_ok: np.ndarray         # (J, R) spread slot live
    sp_pay: np.ndarray        # (J, R)
    sp_jmax: np.ndarray       # (J, R) slowest rank used by spread slot
    sp_nserv: np.ndarray      # (J, R) servers spanned by spread slot
    sp_counts: np.ndarray     # (J, R, M) spread take per key
    found: np.ndarray         # (J,) a best candidate exists
    win_pay: np.ndarray       # (J,) its payoff
    kb: np.ndarray            # (J,) its preference prefix-1
    slot: np.ndarray          # (J,) node row, or N for the spread slot
    node_row: np.ndarray      # (M,) key -> node row


def pricing_tables(jobs: List, avail: np.ndarray, gamma: np.ndarray, ps,
                   now: float, utility, B: int) -> dict:
    """Every host table of one K4 launch over ``jobs`` padded to ``B``
    rows: the kernel's inputs (under the names of
    ``kernels.ops.find_alloc``'s arguments) plus ``jt`` (the job
    tables), ``P`` (unit prices) and ``C``."""
    M = len(ps.keys)
    C = int(max(ps.cap_arr.max(initial=1.0), avail.max(initial=1.0), 1.0))
    jt = _job_tables(jobs, ps, now, utility, B)
    # shared price tables (host NumPy: bitwise Eq. 5 prefixes)
    P = ps.unit_prices(np.asarray(gamma, dtype=float), C)
    cumP = np.zeros((M, C + 1))
    np.cumsum(P, axis=1, out=cumP[:, 1:])
    # batched stable sort of the spread pool (host: NumPy's mergesort is
    # the bitwise reference op)
    avf = np.asarray(avail, dtype=float)
    unit_ok = np.arange(C)[None, :] < avf[:, None]          # (M, C)
    valid = jt.usable[:, :, None] & unit_ok[None, :, :]     # (B, M, C)
    ratio = np.where(valid, P[None, :, :] / jt.x_key[:, :, None], np.inf)
    order = np.argsort(ratio.reshape(B, M * C), axis=-1, kind="stable")
    return {"avail": avf, "cumP": cumP,
            "node_row": np.asarray(ps.node_row, dtype=np.int32),
            "W": jt.W, "Kj": jt.Kj.astype(np.int32), "single": jt.single,
            "rank": jt.rank.astype(np.int32), "u_tab": jt.u_tab,
            "s_rank": np.take_along_axis(np.repeat(jt.rank, C, axis=1),
                                         order, axis=-1).astype(np.int32),
            "s_valid": np.take_along_axis(valid.reshape(B, M * C), order,
                                          axis=-1),
            "s_price": P.reshape(-1)[order],
            "s_key": (order // C).astype(np.int32),
            "n_nodes": ps.n_node_rows, "wmax": _wmax(jt.W),
            "jt": jt, "P": P, "C": C}


FIND_ALLOC_ARGS = ("avail", "cumP", "node_row", "W", "Kj", "single", "rank",
                   "u_tab", "s_rank", "s_valid", "s_price", "s_key")


def find_alloc_batch(jobs: List, avail: np.ndarray, gamma: np.ndarray,
                     ps, now: float, utility, force: bool = False,
                     avail_dev=None, details: bool = False):
    """Standalone FIND_ALLOC candidates for every job in ``jobs`` against
    one shared cluster state, in one launch of K4 — the batched
    equivalent of ``repro_torch.core.dp._find_alloc_arrays`` per job.

    ``avail_dev`` may carry a cached device tensor of ``avail`` (e.g.
    ``ps.device_view('free')``) to skip its upload.  Returns a list
    aligned with ``jobs`` of ``Candidate`` or ``None``, bit-identical to
    the per-job path; with ``details=True`` returns ``(results,
    BatchDetails)`` for the wave partitioner."""
    from repro_torch.core.dp import COMM_COST_FRAC, Candidate

    J = len(jobs)
    if J == 0:
        return ([], None) if details else []
    gtypes = ps.cluster.gpu_types
    N = ps.n_node_rows
    R = len(gtypes)
    tab = pricing_tables(jobs, avail, gamma, ps, now, utility,
                         bucket_size(J))
    jt, P, C = tab["jt"], tab["P"], tab["C"]
    Kj, pref, x_sorted, u_tab = jt.Kj, jt.pref, jt.x_sorted, jt.u_tab
    dev = resolve_device(ps.device)
    args = _to(dev, *(tab[k] for k in FIND_ALLOC_ARGS))
    if avail_dev is not None:
        args[0] = avail_dev
    out = ops.find_alloc(*args, n_nodes=N, comm_frac=COMM_COST_FRAC,
                         wmax=tab["wmax"])
    (feasible, k_first, j_last, take, packed_cost, packed_payoff,
     sp_ok, sp_pay, sp_jmax, sp_nserv, sp_counts) = (
        t.cpu().numpy() for t in out)

    # ---- winner selection in the reference enumeration order -----------
    # flat candidate axis, per job: for each preference prefix k=1..R,
    # the N consolidated node slots (a node is live under its *first*
    # feasible prefix only), then the prefix's spread slot; np.argmax's
    # first-maximum matches the reference's strict-> scan.
    pay = np.full((J, R * (N + 1)), -np.inf)
    for k in range(1, R + 1):
        base = (k - 1) * (N + 1)
        live = feasible[:J] & (k_first[:J] == k - 1)
        pay[:, base:base + N] = np.where(live, packed_payoff[:J], -np.inf)
        pay[:, base + N] = np.where(sp_ok[:J, k - 1], sp_pay[:J, k - 1],
                                    -np.inf)
    pay[Kj[:J] == 0] = -np.inf
    win = np.argmax(pay, axis=1)
    win_pay = pay[np.arange(J), win]

    # ---- winner materialization -----------------------------------------
    # Consolidated winners read the kernel's cost/payoff directly (the
    # kernel sums in the oracle's order over bitwise-identical cumP
    # gathers).  Spread winners re-derive their cost on the host.
    found = win_pay > -np.inf
    kb, slot = np.divmod(win, N + 1)
    is_pack = found & (slot < N)
    results: List = [None] * J
    node_ids = [n.node_id for n in ps.cluster.nodes]

    pj = np.nonzero(is_pack)[0]
    if pj.size:
        hs = slot[pj]
        jl = j_last[pj, hs]
        costs = packed_cost[pj, hs]
        pays = packed_payoff[pj, hs]
        rates = x_sorted[pj, jl]
        takes = take[pj, hs].tolist()              # (Jp, R) python floats
        prefs = pref[pj].tolist()
        kjs = Kj[pj].tolist()
        for i, j in enumerate(pj.tolist()):
            payoff = float(pays[i])
            if payoff <= 0 and not force:    # mu_j <= 0 (lines 29-33)
                continue
            tk = takes[i]
            nid = node_ids[int(hs[i])]
            alloc = {(nid, gtypes[prefs[i][kk]]): int(tk[kk])
                     for kk in range(kjs[i]) if tk[kk] > 0}
            results[j] = Candidate(alloc, float(costs[i]), payoff,
                                   float(rates[i]))

    for j in np.nonzero(found & (slot == N))[0].tolist():
        k = int(kb[j]) + 1                              # spread prefix k
        counts = sp_counts[j, k - 1]
        ms = np.nonzero(counts)[0]
        unit_m = np.repeat(ms, counts[ms])
        unit_i = np.concatenate(
            [np.arange(counts[m]) for m in ms]) if ms.size \
            else np.zeros(0, dtype=np.intp)
        prices = P[unit_m, unit_i]
        # reference summation order == global stable sort restricted
        # to the chosen units: ratio ascending, flat index tiebreak
        o = np.lexsort((unit_m * C + unit_i, prices / jt.x_key[j, unit_m]))
        cost = float(prices[o].sum())
        jmax = int(sp_jmax[j, k - 1])
        nserv = int(sp_nserv[j, k - 1])
        if nserv > 1:
            cost += COMM_COST_FRAC * max(u_tab[j, jmax], 0.0) * (nserv - 1)
        payoff = float(u_tab[j, jmax] - cost)
        if payoff <= 0 and not force:       # mu_j <= 0 (lines 29-33)
            continue
        alloc = {ps.keys[m]: int(counts[m]) for m in ms}
        results[j] = Candidate(alloc, cost, payoff,
                               float(x_sorted[j, jmax]))
    if details:
        det = BatchDetails(
            avail0=tab["avail"].copy(), cumP=tab["cumP"], u_tab=u_tab[:J],
            rank=jt.rank[:J], usable=jt.usable[:J], Kj=Kj[:J],
            single=jt.single[:J], feasible=feasible[:J],
            k_first=k_first[:J], packed_payoff=packed_payoff[:J],
            sp_ok=sp_ok[:J], sp_pay=sp_pay[:J], sp_jmax=sp_jmax[:J],
            sp_nserv=sp_nserv[:J], sp_counts=sp_counts[:J],
            found=found, win_pay=win_pay, kb=kb, slot=slot,
            node_row=np.asarray(ps.node_row))
        return results, det
    return results


# --------------------------------------------------------------------------
# Conflict-free wave partitioner (greedy commit without host round-trips)
# --------------------------------------------------------------------------
#
# The sequential oracle re-solves FIND_ALLOC per job at the accumulated
# state.  A wave accepts a prefix of the commit order for which that
# re-solve provably returns the already-known standalone winner:
#
# - *winner invariance*: the winner's own slot sees none of the keys
#   committed so far in the wave, so its take/cost/payoff/position are
#   all bitwise unchanged, and accepted winners' key sets are pairwise
#   disjoint.
# - *payoff-gap bound* on every affected competitor slot: committing v_m
#   units on key m removes its v_m cheapest units, which can only shift
#   a competitor onto *cheaper* less-preferred keys — raising its payoff
#   by at most ``topv(m)``, the price of m's v_m most expensive free
#   units.  The bound needs the utility non-increasing along the
#   preference order (checked per job, else the wave breaks).  Affected
#   slots must stay strictly below the winner with a relative margin.
# - feasibility/eligibility only shrink when availability shrinks, so
#   slots dead at wave start stay dead, and a job whose standalone
#   re-solve was rejected (mu_j <= 0) stays rejected iff no affected
#   slot's bound can cross the admission gate.

_WAVE_EPS = 1e-9         # relative strictness margin on payoff bounds
_WAVE_MIN_RESCAN = 8     # waves consuming fewer jobs stall -> scan


def _spread_bound(det: BatchDetails, r: int, k: int, T: np.ndarray,
                  tv: np.ndarray, d: float, comm_frac: float) -> float:
    """Upper bound on spread slot ``k``'s payoff after the wave delta.

    The slot's raw unit cost (comm term stripped) can drop by at most
    ``d`` (the topv sum over touched keys in its pool), and its utility
    can rise at most to the slowest rank still guaranteed in the chosen
    set (committed units evict a key's cheapest units first, so a key's
    surviving chosen count is ``count - v_m``)."""
    jmax = int(det.sp_jmax[r, k - 1])
    nserv = int(det.sp_nserv[r, k - 1])
    u_jmax = float(det.u_tab[r, jmax])
    cost_incl = u_jmax - float(det.sp_pay[r, k - 1])
    comm = comm_frac * max(u_jmax, 0.0) * (nserv - 1) if nserv > 1 \
        else 0.0
    unit_cost = cost_incl - comm
    counts = det.sp_counts[r, k - 1]
    kept = counts - np.where(T, np.minimum(counts, tv), 0)
    mk = np.nonzero(kept > 0)[0]
    r_keep = int(det.rank[r, mk].max()) if mk.size else 0
    return float(det.u_tab[r, r_keep]) - (unit_cost - d)


def _wave_safe(det: BatchDetails, r: int, T: np.ndarray, tv: np.ndarray,
               a0: np.ndarray, comm_frac: float,
               has_winner: bool) -> bool:
    """Is row ``r``'s standalone outcome (its winner, or its rejection
    when ``has_winner`` is False) provably unchanged by the wave delta
    ``tv`` on touched keys ``T``?"""
    kj = int(det.Kj[r])
    if kj == 0:
        return True                       # no usable type: None forever
    u_row = det.u_tab[r, :kj]
    if kj > 1 and np.any(np.diff(u_row) > 0):
        return False                      # exotic utility: exact re-solve
    ms = np.nonzero(T)[0]
    rank_r = det.rank[r]
    N = det.packed_payoff.shape[1]
    if has_winner:
        slot = int(det.slot[r])
        k_win = int(det.kb[r]) + 1
        win_is_pack = slot < N
        if win_is_pack:
            if np.any(det.node_row[ms] == slot):
                return False              # winner's node was touched
        elif np.any(rank_r[ms] < k_win):
            return False                  # winner's spread pool touched
        win_pay = float(det.win_pay[r])
        bar = win_pay - _WAVE_EPS * max(1.0, abs(win_pay))
    else:
        slot = -1
        k_win = 0
        win_is_pack = False
        bar = 0.0                         # the mu_j admission gate

    # topv(m): price of key m's tv[m] most expensive free units — the
    # largest amount a competitor's cost can drop by re-sourcing the
    # displaced demand (cumP rows are host-exact Eq. 5 prefixes)
    topv = det.cumP[ms, a0[ms]] - det.cumP[ms, a0[ms] - tv[ms]]
    node_ms = det.node_row[ms]
    for h in np.unique(node_ms):
        if win_is_pack and h == slot:
            continue
        if not det.feasible[r, h]:
            continue                      # availability only shrinks
        bound = float(det.packed_payoff[r, h]) + float(
            topv[node_ms == h].sum())
        if not bound < bar - _WAVE_EPS * max(0.0, abs(bound) - 1.0):
            return False
    if not det.single[r]:
        rmin = int(rank_r[ms].min())
        for k in range(rmin + 1, kj + 1):
            if not win_is_pack and has_winner and k == k_win:
                continue
            if not det.sp_ok[r, k - 1]:
                continue                  # eligibility only shrinks
            d = float(topv[rank_r[ms] < k].sum())
            bound = _spread_bound(det, r, k, T, tv, d, comm_frac)
            if not bound < bar - _WAVE_EPS * max(0.0, abs(bound) - 1.0):
                return False
    return True


def _wave_accepts(det: BatchDetails, cands: List, rows: List[int],
                  key_index: Dict) -> Tuple[List, int, np.ndarray]:
    """Walk ``rows`` (det-row indices in commit order) accepting jobs
    while the wave-safety test holds.  Returns ``(accepted, consumed,
    delta)``: the accepted ``(row, Candidate)`` pairs, how many leading
    rows were consumed (accepts + provably-still-rejected skips), and
    the aggregated per-key commit counts of the wave."""
    from repro_torch.core.dp import COMM_COST_FRAC

    M = det.avail0.shape[0]
    touched = np.zeros(M, dtype=bool)
    tv = np.zeros(M, dtype=np.int64)
    a0 = det.avail0.astype(np.int64)
    accepted: List = []
    consumed = 0
    for r in rows:
        c = cands[r]
        T = touched & det.usable[r]
        if T.any() and not _wave_safe(det, r, T, tv, a0, COMM_COST_FRAC,
                                      has_winner=c is not None):
            break
        consumed += 1
        if c is None:
            continue
        accepted.append((r, c))
        for key, v in c.alloc.items():
            m = key_index[key]
            touched[m] = True
            tv[m] += v
    return accepted, consumed, tv


# --------------------------------------------------------------------------
# The sequential commit on the card: one launch of K5 over the remainder
# --------------------------------------------------------------------------

def scan_tables(jobs: List, avail: np.ndarray, gamma: np.ndarray, ps,
                now: float, utility, B: int) -> dict:
    """Every host table of one K5 launch over ``jobs`` (in commit order)
    padded to ``B`` rows: the kernel's inputs (under the names of
    ``kernels.ops.commit_scan``'s arguments) plus ``jt`` and ``C``.

    Gamma stays integer on the greedy path, so each step's Eq. 5 prices
    are gathers from ``P_tab[m, u] = umin (umax/umin)^(u/cap)`` at index
    ``gamma + i``, bitwise the oracle's ``unit_prices(gamma)[m, i]``.  The
    spread pool needs no sort inside the scan: the oracle's stable sort
    key is ``(price/throughput, m*c + i)``, each key's ratio is
    non-decreasing in the absolute unit index and the flat-index
    tie-break depends only on the key, so one gamma-independent order
    over the whole (key, unit) table, sorted here by NumPy's stable
    mergesort, is the pool order at every step; a step only masks the
    window ``gamma_m <= u < gamma_m + free_m``."""
    M = len(ps.keys)
    # unit indices reach gamma + free - 1 and gamma_m + free_m is
    # invariant across the scan; gamma may exceed cap - free (replayed
    # occupancy), so size on both
    depth = (np.asarray(gamma, dtype=float)
             + np.asarray(avail, dtype=float)).max(initial=1.0)
    C = int(max(ps.cap_arr.max(initial=1.0), depth, 1.0))
    jt = _job_tables(jobs, ps, now, utility, B)
    P_tab = ps.unit_prices(np.zeros(M), C)
    node_row = np.asarray(ps.node_row, dtype=np.int32)
    ratio = np.where(jt.usable[:, :, None],
                     P_tab[None, :, :] / jt.x_key[:, :, None], np.inf)
    order = np.argsort(ratio.reshape(B, M * C), axis=-1, kind="stable")
    s_m = (order // C).astype(np.int32)
    return {"free": np.asarray(avail, dtype=float),
            "gamma": np.asarray(gamma, dtype=np.int32),
            "P_tab": P_tab, "node_row": node_row, "W": jt.W,
            "Kj": jt.Kj.astype(np.int32), "single": jt.single,
            "rank": jt.rank.astype(np.int32), "u_tab": jt.u_tab,
            "s_m": s_m, "s_u": (order % C).astype(np.int32),
            "s_rank": np.take_along_axis(jt.rank, s_m,
                                         axis=1).astype(np.int32),
            "s_price": P_tab.reshape(-1)[order], "s_node": node_row[s_m],
            "n_nodes": ps.n_node_rows, "wmax": _wmax(jt.W),
            "jt": jt, "C": C}


COMMIT_SCAN_ARGS = ("free", "gamma", "P_tab", "node_row", "W", "Kj",
                    "single", "rank", "u_tab", "s_m", "s_u", "s_rank",
                    "s_price", "s_node")


def _scan_commit(jobs: List, avail: np.ndarray, gamma: np.ndarray,
                 ps, now: float, utility) -> Dict:
    """Run the sequential greedy commit over ``jobs`` (already in commit
    order) in one launch of K5; mutates ``avail``/``gamma`` in place and
    returns ``{job_id: Candidate}`` for the winners.  Winner cost/payoff/
    rate are re-derived host-exact from the per-step counts and the
    accumulated gamma."""
    from repro_torch.core.dp import COMM_COST_FRAC, Candidate

    J = len(jobs)
    if J == 0:
        return {}
    N = ps.n_node_rows
    tab = scan_tables(jobs, avail, gamma, ps, now, utility, bucket_size(J))
    jt, C, P_tab, node_row = tab["jt"], tab["C"], tab["P_tab"], ps.node_row
    out = ops.commit_scan(
        *_to(resolve_device(ps.device), *(tab[k] for k in COMMIT_SCAN_ARGS)),
        n_nodes=N, comm_frac=COMM_COST_FRAC, wmax=tab["wmax"])
    free_f, _, won, win, counts = (t.cpu().numpy() for t in out[:5])

    results: Dict = {}
    gam_run = np.asarray(gamma, dtype=np.int64).copy()
    for p in range(J):
        if not won[p]:
            continue
        cnts = counts[p]
        ms = np.nonzero(cnts)[0]
        slotp = int(win[p]) % (N + 1)
        jl = int(jt.rank[p, ms].max())      # slowest rank actually used
        if slotp < N:
            # consolidated: cost = sum over preference ranks of the key's
            # sequential unit-price prefix (np.cumsum order)
            cost = 0.0
            alloc = {}
            for m in ms[np.argsort(jt.rank[p, ms], kind="stable")]:
                g = int(gam_run[m])
                cnt = int(cnts[m])
                cost += float(np.cumsum(P_tab[m, g:g + cnt])[-1])
                alloc[ps.keys[m]] = cnt
        else:
            unit_m = np.repeat(ms, cnts[ms])
            unit_i = np.concatenate([np.arange(cnts[m]) for m in ms])
            prices = P_tab[unit_m, gam_run[unit_m] + unit_i]
            # reference summation order == stable sort of the chosen
            # units by (ratio, flat index)
            o = np.lexsort((unit_m * C + unit_i,
                            prices / jt.x_key[p, unit_m]))
            cost = float(prices[o].sum())
            nserv = int(np.unique(node_row[ms]).size)
            if nserv > 1:
                cost += COMM_COST_FRAC * max(jt.u_tab[p, jl], 0.0) \
                    * (nserv - 1)
            alloc = {ps.keys[m]: int(cnts[m]) for m in ms}
        payoff = float(jt.u_tab[p, jl] - cost)
        results[jobs[p].job_id] = Candidate(alloc, float(cost), payoff,
                                            float(jt.x_sorted[p, jl]))
        gam_run[ms] += cnts[ms]

    total = counts[:J].sum(axis=0)
    avail -= total
    gamma += total
    # the kernel's carry is what the host applies (integer-valued floats)
    if not np.array_equal(free_f, np.asarray(avail, dtype=float)):
        raise RuntimeError("commit_scan: the carried free vector differs "
                           "from the host's commit")
    return results


def commit_greedy(queue: List, avail: np.ndarray, gamma: np.ndarray,
                  ps, now: float, utility, avail_dev=None) -> Dict:
    """The greedy pass of ``dp_allocation`` without per-job host
    round-trips: one K4 launch ranks all standalone winners,
    conflict-free waves commit in aggregated deltas, and the conflicting
    remainder runs through one K5 launch.  Mutates ``avail``/``gamma`` in
    place and returns ``{job_id: Candidate}`` bit-identical to the
    sequential NumPy loop (``repro_torch.core.dp``)."""
    cands, det = find_alloc_batch(queue, avail, gamma, ps, now, utility,
                                  avail_dev=avail_dev, details=True)
    # payoff *density* order (per requested device), ties in queue order
    # — identical to the sequential loop's sort
    dens = [(c.payoff / max(1, j.n_workers), i)
            for i, (j, c) in enumerate(zip(queue, cands)) if c]
    dens.sort(key=lambda t: -t[0])
    rows = [i for _, i in dens]
    chosen: Dict = {}
    cur_jobs = queue
    key_index = ps.key_index
    while rows:
        accepted, consumed, tv = _wave_accepts(det, cands, rows,
                                               key_index)
        for r, c in accepted:
            chosen[cur_jobs[r].job_id] = c
        if tv.any():
            avail -= tv.astype(avail.dtype)
            gamma += tv.astype(gamma.dtype)
        rows = rows[consumed:]
        if not rows:
            break
        rest = [cur_jobs[r] for r in rows]
        if consumed < _WAVE_MIN_RESCAN:
            # the wave stalled on conflicts: finish the remainder in one
            # launch of K5 (sequential re-pricing stays on the card)
            chosen.update(_scan_commit(rest, avail, gamma, ps, now,
                                       utility))
            break
        cands, det = find_alloc_batch(rest, avail, gamma, ps, now,
                                      utility, details=True)
        cur_jobs = rest
        rows = list(range(len(rest)))
    return chosen

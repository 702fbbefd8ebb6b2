"""Plain PyTorch versions of the hand-written kernels (the allclose targets).

They run on any device.  The wrappers in ``ops`` take them for tensors that
lie on the CPU; ``chip_smoke.py`` holds each kernel against them on the
card.  The two scheduler kernels (``find_alloc_ref``, ``commit_scan_ref``)
are float64 and bitwise: every sum is taken in the order the NumPy oracle
``repro_torch.core.dp._find_alloc_arrays`` takes it (``pairwise_sum``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,Hq,S,D); k,v: (B,Hkv,S,D) -> (B,Hq,S,D).  GQA by head
    grouping; optional causal + sliding-window masking; f32 math."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, S, D).float()
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) / math.sqrt(D)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= kj > qi - window
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vf)
    return out.reshape(B, Hq, S, D).to(q.dtype)


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """r,k,v,w: (B,H,S,D); u: (H,D); state: (B,H,D,D).
    WKV6: S_t = diag(w_t) S_{t-1} + k_t^T v_t; o_t = r_t (diag(u)k_t^T v_t
    + S_{t-1}), sequentially in float32.  Returns (out (B,H,S,D) in r's
    dtype, new_state (B,H,D,D) float32)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = state.float()
    outs = []
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]   # (B,H,D,D)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], uf * kv + s))
        s = wf[:, :, t, :, None] * s + kv
    return torch.stack(outs, 2).to(r.dtype), s


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,).  x * rsqrt(mean(x^2) + eps) * scale in
    float32, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# scheduler kernels (float64, bitwise)
# ---------------------------------------------------------------------------

PW_BLOCK = 128  # NumPy's pairwise-summation block (PW_BLOCKSIZE)


def pairwise_sum(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """NumPy's float64 ``sum`` of the first ``n[...]`` entries of each
    row of ``v`` (..., L), in NumPy's own order: fewer than 8 values are
    added one by one from 0.0; from 8 to 128, eight running sums over
    strides of 8, combined as ((s0+s1)+(s2+s3))+((s4+s5)+(s6+s7)), then
    the remainder one by one.  Longer rows raise (``PW_BLOCK``)."""
    L = v.shape[-1]
    if L > PW_BLOCK:
        raise ValueError(f"pairwise_sum takes at most {PW_BLOCK} values a "
                         f"row, got {L}")
    zero = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    small = zero
    for i in range(min(L, 7)):
        small = torch.where(i < n, small + v[..., i], small)
    if L < 8:
        return small
    whole = n - n % 8  # values summed by the eight running sums
    acc = [v[..., j] for j in range(8)]
    for i in range(8, L - 7, 8):
        for j in range(8):
            acc[j] = torch.where(i < whole, acc[j] + v[..., i + j], acc[j])
    res = ((acc[0] + acc[1]) + (acc[2] + acc[3])) \
        + ((acc[4] + acc[5]) + (acc[6] + acc[7]))
    for i in range(8, L):
        res = torch.where((i >= whole) & (i < n), res + v[..., i], res)
    return torch.where(n < 8, small, res)


def _first_w(elig: torch.Tensor, W: torch.Tensor, wmax: int):
    """Positions of the first min(W, count) True entries of each row of
    ``elig`` (..., L), in order: (positions (..., wmax) clamped to L-1,
    valid (..., wmax), count (...))."""
    csum = torch.cumsum(elig.to(torch.int32), dim=-1)
    n_elig = csum[..., -1]
    t = torch.arange(1, wmax + 1, dtype=torch.int32, device=elig.device)
    t = t.expand(*elig.shape[:-1], wmax).contiguous()
    pos = torch.searchsorted(csum.contiguous(), t)
    valid = (t <= W[..., None]) & (t <= n_elig[..., None])
    return pos.clamp_max(elig.shape[-1] - 1), valid, n_elig


def _distinct(nodes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Count of distinct values among the valid entries of each row."""
    w = nodes.shape[-1]
    earlier = torch.ones(w, w, dtype=torch.bool,
                         device=nodes.device).tril(-1)    # [t, s]: s < t
    dup = ((nodes[..., :, None] == nodes[..., None, :])
           & valid[..., None, :] & earlier).any(-1)
    return (valid & ~dup).sum(-1).to(torch.int32)


def _comm(cost, nserv, u_jmax, comm_frac: float):
    """cost plus the communication term of a spread candidate that spans
    more than one server, multiplied as the NumPy oracle does."""
    extra = comm_frac * u_jmax.clamp_min(0.0) * (nserv - 1).to(cost.dtype)
    return torch.where(nserv > 1, cost + extra, cost)


def _consolidated(avail_use, node_row, rank, W, n_nodes: int, R: int):
    """Consolidated slots of a batch of jobs against per-job usable
    availability ``avail_use`` (B, M): (feasible, k_first, j_last, take
    (B, N, R), t_key (B, M) int64), where t_key is the take of each key's
    (node, rank) cell."""
    B, M = rank.shape
    b = torch.arange(B, device=rank.device)[:, None].expand(B, M)
    nr = node_row.long()[None, :].expand(B, M)
    A = torch.zeros((B, n_nodes, R + 1), dtype=torch.float64,
                    device=rank.device)
    A.index_put_((b, nr, rank), avail_use, accumulate=True)
    A = A[..., :R]
    Apos = A.clamp_min(0.0)
    Wc = W[:, None]
    rc = torch.zeros((B, n_nodes), dtype=torch.float64, device=rank.device)
    pc = torch.zeros_like(rc)
    feas, full, take = [], [], []
    for k in range(R):
        rc = rc + A[..., k]
        pc = pc + Apos[..., k]
        feas.append(rc >= Wc)
        full.append(pc >= Wc)
        take.append(torch.minimum((Wc - (pc - Apos[..., k])).clamp_min(0.0),
                                  Apos[..., k]))
    feas = torch.stack(feas, -1)
    full = torch.stack(full, -1)
    take = torch.stack(take, -1)
    k_first = feas.to(torch.uint8).argmax(-1).to(torch.int32)
    j_last = full.to(torch.uint8).argmax(-1).to(torch.int32)
    take_pad = torch.cat([take, torch.zeros_like(take[..., :1])], -1)
    t_key = take_pad[b, nr, rank].long()
    return feas.any(-1), k_first, j_last, take, t_key


def find_alloc_ref(avail, cumP, node_row, W, Kj, single, rank, u_tab,
                   s_rank, s_valid, s_price, s_key, n_nodes: int,
                   comm_frac: float, wmax: int):
    """Plain version of kernel K4 (``find_alloc``): FIND_ALLOC of B jobs
    against one shared state.

    avail (M,) f64 free units; cumP (M, C+1) f64 unit-price prefix sums;
    node_row (M,) int32; per job: W (B,) f64 gang size, Kj (B,) int32
    usable-type count, single (B,) bool, rank (B, M) int32 preference rank
    of each key's type (R = unusable), u_tab (B, R) f64 utility per rank;
    the job's spread pool in its stable sort order: s_rank, s_key (B, L)
    int32, s_valid (B, L) bool, s_price (B, L) f64.  ``wmax`` >= max W.

    Returns feasible (B,N) bool, k_first, j_last (B,N) int32, take
    (B,N,R) f64, packed_cost, packed_payoff (B,N) f64; per spread prefix
    k = 1..R: sp_ok (B,R) bool, sp_pay (B,R) f64, sp_jmax, sp_nserv
    (B,R) int32, sp_counts (B,R,M) int32."""
    B, M = rank.shape
    R = u_tab.shape[1]
    N = n_nodes
    rk = rank.long()
    Kl = Kj.long()
    usable = rk < Kl[:, None]
    feasible, k_first, j_last, take, t_key = _consolidated(
        torch.where(usable, avail[None, :], 0.0), node_row, rk, W, N, R)
    keys = torch.arange(M, device=rank.device)[None, :].expand(B, M)
    v = torch.where(usable, cumP[keys, t_key], 0.0)
    b = torch.arange(B, device=rank.device)[:, None].expand(B, M)
    vs = torch.zeros((B, N, R + 1), dtype=torch.float64, device=rank.device)
    vs.index_put_((b, node_row.long()[None, :].expand(B, M), rk), v,
                  accumulate=True)
    packed_cost = pairwise_sum(vs[..., :R], Kl[:, None].expand(B, N))
    packed_payoff = u_tab.gather(1, j_last.long()) - packed_cost

    Wi = W.to(torch.int32)
    ok, pay, jmax_l, nserv_l, counts_l = [], [], [], [], []
    for k in range(1, R + 1):
        elig = s_valid & (s_rank < k)
        pos, valid, n_elig = _first_w(elig, Wi, wmax)
        g_pr = s_price.gather(1, pos)
        g_rk = s_rank.gather(1, pos)
        g_key = s_key.gather(1, pos).long()
        cost = pairwise_sum(torch.where(valid, g_pr, 0.0), valid.sum(-1))
        jmax = torch.where(valid, g_rk, -1).amax(-1)
        nserv = _distinct(node_row[g_key], valid)
        u_jmax = u_tab.gather(1, jmax.clamp_min(0).long()[:, None])[:, 0]
        cost = _comm(cost, nserv, u_jmax, comm_frac)
        ok.append((n_elig >= Wi) & ~single & (k <= Kj))
        pay.append(u_jmax - cost)
        jmax_l.append(jmax.to(torch.int32))
        nserv_l.append(nserv)
        counts_l.append(torch.zeros((B, M), dtype=torch.int32,
                                    device=rank.device).scatter_add_(
            1, g_key, valid.to(torch.int32)))
    return (feasible, k_first, j_last, take, packed_cost, packed_payoff,
            torch.stack(ok, 1), torch.stack(pay, 1), torch.stack(jmax_l, 1),
            torch.stack(nserv_l, 1), torch.stack(counts_l, 1))


def commit_scan_ref(free, gamma, P_tab, node_row, W, Kj, single, rank,
                    u_tab, s_m, s_u, s_rank, s_price, s_node, n_nodes: int,
                    comm_frac: float, wmax: int, need: list = None):
    """Plain version of kernel K5 (``commit_scan``): the greedy commit of
    B >= 1 jobs, in order, each a full FIND_ALLOC at the carried (free, gamma)
    state, its winner committed into the carry before the next job.

    free (M,) f64, gamma (M,) int32: the state before the first job;
    P_tab (M, C) f64 Eq. 5 prices by absolute unit index; node_row (M,)
    int32; per job: W (B,) f64, Kj (B,) int32, single (B,) bool, rank
    (B, M) int32, u_tab (B, R) f64, and its fixed spread-pool order over
    the whole (key, unit) table: s_m, s_u, s_rank, s_node (B, L) int32,
    s_price (B, L) f64.  ``wmax`` >= max W.

    Returns the final free (M,) f64 and gamma (M,) int32, and per job:
    won (B,) bool (winner found and mu_j > 0), win (B,) int32 (its slot
    k*(N+1)+h, h = N for the spread slot), counts (B, M) int32 (units
    committed per key), win2 (B,) int32 and win2_pay (B,) f64 (the
    runner-up), sp_nserv (B, R) int32.  With a list ``need``, appends
    per job what it had to read of its pool (for a data-dependent bound):
    (the length of the pool prefix through the W-th eligible unit of its
    longest walk, the units its walks choose).  A prefix with fewer than
    W eligible units reads nothing: its count, its servers and its
    refusal follow from the carry alone."""
    B, M = rank.shape
    R = u_tab.shape[1]
    N = n_nodes
    C = P_tab.shape[1]
    dev = rank.device
    free = free.clone()
    gamma = gamma.clone()
    keys = torch.arange(M, device=dev)
    out = {"won": [], "win": [], "counts": [], "win2": [], "win2_pay": [],
           "sp_nserv": []}
    neg = torch.tensor(-math.inf, dtype=torch.float64, device=dev)
    for p in range(B):
        wi = W[p].to(torch.int32)
        kj = Kj[p]
        rk = rank[p].long()
        usable = rk < kj
        feasible, k_first, j_last, _, t_key = _consolidated(
            torch.where(usable, free, 0.0)[None], node_row, rk[None],
            W[p:p + 1], N, R)
        feasible, k_first, j_last, t_key = (feasible[0], k_first[0],
                                            j_last[0], t_key[0])
        vkey = torch.zeros(M, dtype=torch.float64, device=dev)
        for i in range(C):  # unit by unit, as NumPy's cumsum
            price = P_tab[keys, (gamma + i).clamp_max(C - 1).long()]
            vkey = torch.where(i < t_key, vkey + price, vkey)
        vkey = torch.where(usable, vkey, 0.0)
        vs = torch.zeros((N, R + 1), dtype=torch.float64, device=dev)
        vs.index_put_((node_row.long(), rk), vkey, accumulate=True)
        packed_cost = pairwise_sum(vs[:, :R], kj.long().expand(N))
        packed_payoff = u_tab[p][j_last.long()] - packed_cost

        lo = gamma[s_m[p].long()]
        in_window = (s_u[p] >= lo) \
            & ((s_u[p] - lo).to(torch.float64) < free[s_m[p].long()])
        ks = torch.arange(1, R + 1, device=dev)[:, None]
        elig = in_window[None, :] & (s_rank[p][None, :] < ks)   # (R, L)
        pos, valid, n_elig = _first_w(elig, wi.expand(R), wmax)
        if need is not None:  # the prefixes with at least W eligible units
            w = int(wi)
            walked = n_elig >= wi
            reach = (int(torch.where(walked, pos[:, w - 1] + 1, 0).max())
                     if w and int(kj) else 0)
            need.append((reach, w * int(walked.sum()) if int(kj) else 0))
        g_m = s_m[p][pos].long()
        cost = pairwise_sum(torch.where(valid, s_price[p][pos], 0.0),
                            valid.sum(-1))
        jmax = torch.where(valid, s_rank[p][pos], -1).amax(-1)
        nserv = _distinct(s_node[p][pos], valid)
        u_jmax = u_tab[p][jmax.clamp_min(0).long()]
        cost = _comm(cost, nserv, u_jmax, comm_frac)
        sp_ok = (n_elig >= wi) & ~single[p] & (ks[:, 0] <= kj)
        sp_pay = u_jmax - cost

        live = feasible[None, :] & (k_first[None, :].long() == ks - 1)
        pay = torch.cat([torch.where(live, packed_payoff[None, :], neg),
                         torch.where(sp_ok, sp_pay, neg)[:, None]], 1)
        pay = torch.where(kj > 0, pay.reshape(-1), neg)
        win = int(pay.argmax())
        won = bool(pay[win] > 0.0)            # the mu_j > 0 gate
        kb, slot = divmod(win, N + 1)
        counts = torch.zeros(M, dtype=torch.int32, device=dev)
        if won and slot < N:
            counts = torch.where(node_row.long() == slot, t_key,
                                 0).to(torch.int32)
        elif won:
            counts.scatter_add_(0, g_m[kb], valid[kb].to(torch.int32))
        pay[win] = -math.inf
        win2 = int(pay.argmax())
        free = free - counts.to(torch.float64)
        gamma = gamma + counts
        for name, val in (("won", won), ("win", win), ("counts", counts),
                          ("win2", win2), ("win2_pay", pay[win2]),
                          ("sp_nserv", nserv)):
            out[name].append(val)
    return (free, gamma,
            torch.tensor(out["won"], dtype=torch.bool, device=dev),
            torch.tensor(out["win"], dtype=torch.int32, device=dev),
            torch.stack(out["counts"]),
            torch.tensor(out["win2"], dtype=torch.int32, device=dev),
            torch.stack(out["win2_pay"]), torch.stack(out["sp_nserv"]))

"""The decomposition of K2b's "cluster" form (``csrc/rwkv6_scan_bwd.cu``),
emulated in PyTorch on the CPU in float32 and held against ``jax.grad`` of
the JAX package's plain scan (``repro.kernels.ref.rwkv6_scan_ref``) and
against a float64 gradient; and K2b's launch planner.

``emulate`` does what the kernel does, in its order: the replay writes the
state before every 16-step chunk; the chunks are walked from the last,
each re-deriving its 16 states from its checkpoint; the keys are split
into blocks of 16 (one block of a (batch, head)'s cluster each), a warp
of a block owns 16 value columns, a thread 2 keys and 4 columns.  Each
step's sums over the value columns (dk and dw from the adjoint, dr from
the state) are summed over a thread's 4 columns, then over its key
group's 4 lanes as a pairwise tree, then over the warps in order; dv's
sum over the keys over a thread's 2 keys, then over the warp's 8 key
groups as a pairwise tree (the block's 16 keys), then over the cluster's
blocks in rank order; do . v and sum r u k likewise.  A fused
multiply-add is rounded once (``_fma``).

Tolerances: each gradient's max abs error within 2e-5 of its largest
|value|, against ``jax.grad`` in float32 and against the float64 gradient
(the two float32 orders and float64 agree to ~1e-6 of the largest value
at these lengths).  Inputs are made with numpy from a seed; the JAX side
runs its plain scan on the CPU, as the JAX package's own tests do.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import rwkv6_scan_ref as jax_scan
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan_bwd as rkb

C = rkb.CHUNK   # steps a chunk
KB = rkb.KEYS   # keys a block
TOL = 2e-5


def _fma(a, b, c):
    """float32 a * b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _tree(x):
    """The pairwise sum over the last dim (a power of two) that a
    butterfly of shuffles gives: ((x0 + x1) + (x2 + x3)) + ..."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _in_order(x):
    """The sum over the last dim from 0 in order."""
    s = torch.zeros(x.shape[:-1])
    for q in range(x.shape[-1]):
        s = s + x[..., q]
    return s


def _col_sum(a, b):
    """sum_j a[i, j] b[i, j] (both (D, D)) as the kernel sums over the
    value columns: a thread's 4 columns by fused multiply-adds, its key
    group's 4 lanes pairwise, the warps (16 columns each) in order."""
    D = a.shape[0]
    a4, b4 = a.view(D, D // 16, 4, 4), b.view(D, D // 16, 4, 4)
    p = a4[..., 0] * b4[..., 0]
    for m in range(1, 4):
        p = _fma(a4[..., m], b4[..., m], p)
    return _in_order(_tree(p))                          # (D,)


def _dov(do_t, v_t):
    """do . v over all D columns as the kernel sums it: lane p of 8 sums
    columns p, p + 8, ... in order by fused multiply-adds, then the 8
    lanes pairwise."""
    D = do_t.shape[0]
    d8, v8 = do_t.view(D // 8, 8).T, v_t.view(D // 8, 8).T
    part = torch.zeros(8)
    for q in range(D // 8):
        part = _fma(d8[:, q], v8[:, q], part)
    return _tree(part)


def emulate(r, k, v, w, u, s0, do):
    """dr, dk, dv, dw (S, D) and du (D,) of one (batch, head) in the
    kernel's decomposition and order; float32 (S, D) r, k, v, w, do, (D,)
    u, (D, D) s0."""
    S, D = r.shape
    CL = D // KB
    nch = -(-S // C)
    # the replay: the state before each chunk
    ck, st = [], s0.clone()
    for ch in range(nch):
        ck.append(st.clone())
        for t in range(ch * C, min(S, ch * C + C)):
            st = _fma(w[t][:, None], st, k[t][:, None] * v[t][None, :])
    dr, dk, dv, dw = (torch.zeros(S, D) for _ in range(4))
    A = torch.zeros(D, D)
    du = torch.zeros(D)
    for ch in reversed(range(nch)):
        t0, n = ch * C, min(C, S - ch * C)
        states = [ck[ch]]
        for c in range(n - 1):
            t = t0 + c
            states.append(_fma(w[t][:, None], states[-1],
                               k[t][:, None] * v[t][None, :]))
        for c in reversed(range(n)):
            t = t0 + c
            dov = _dov(do[t], v[t])
            # sum r u k: 8 parts of 2 keys a block, pairwise, ranks in order
            ru = r[t] * u
            kp = ru.view(CL, KB // 2, 2)
            kk = k[t].view(CL, KB // 2, 2)
            part = _fma(kp[..., 1], kk[..., 1], kp[..., 0] * kk[..., 0])
            rku = _in_order(_tree(part))
            sk = _col_sum(A, v[t][None, :].expand(D, D))
            sw = _col_sum(A, states[c])
            sr = _col_sum(states[c], do[t][None, :].expand(D, D))
            dk[t] = _fma(ru, dov, sk)
            dw[t] = sw
            dr[t] = _fma(u * k[t], dov, sr)
            # dv: a thread's 2 keys, the warp's 8 key groups pairwise (a
            # block's 16 keys), the blocks in rank order
            a2 = A.view(CL, KB // 2, 2, D)
            k2 = k[t].view(CL, KB // 2, 2, 1)
            pair = _fma(a2[:, :, 1], k2[:, :, 1], a2[:, :, 0] * k2[:, :, 0])
            per_block = _tree(pair.permute(0, 2, 1))        # (CL, D)
            dv[t] = _fma(rku, do[t], _in_order(per_block.T))
            A = _fma(w[t][:, None], A, r[t][:, None] * do[t][None, :])
        for c in reversed(range(n)):
            t = t0 + c
            du = _fma(r[t] * k[t], _dov(do[t], v[t]), du)
    return dr, dk, dv, dw, du


def emulate_all(r, k, v, w, u, s0, do):
    """``emulate`` of every (batch, head) of kernel-layout (B,H,S,D)
    inputs; du summed over the batch in order, as the kernel's last
    pass does."""
    B, H = r.shape[:2]
    outs = [[emulate(r[b, h], k[b, h], v[b, h], w[b, h], u[h], s0[b, h],
                     do[b, h]) for h in range(H)] for b in range(B)]
    grads = [torch.stack([torch.stack([outs[b][h][g] for h in range(H)])
                          for b in range(B)]) for g in range(4)]
    du = torch.zeros(H, r.shape[-1])
    for b in range(B):
        du = du + torch.stack([outs[b][h][4] for h in range(H)])
    return (*grads, du)


def _inputs(B, H, S, D, seed, zero=False):
    """float32 numpy r, k, v, w, u, s0, do with the smoke's statistics;
    ``zero``: decays of exactly 0 over steps 5-9 and 0.01 over 3-20."""
    rs = np.random.RandomState(seed)
    r, k, v = (0.5 * rs.standard_normal((B, H, S, D)) for _ in range(3))
    w = 1 / (1 + np.exp(-(rs.standard_normal((B, H, S, D)) - 1))) * 0.98 + 0.01
    if zero:
        w[:, :, 3:21] = 0.01
        w[:, :, 5:10] = 0.0
    u = 0.3 * rs.standard_normal((H, D))
    s0 = 0.2 * rs.standard_normal((B, H, D, D))
    do = rs.standard_normal((B, H, S, D))
    return [x.astype(np.float32) for x in (r, k, v, w, u, s0, do)]


def _jax_grads(r, k, v, w, u, s0, do):
    """jax.grad of sum(rwkv6_scan_ref(...)[0] * do) in float32."""
    def f(r, k, v, w, u):
        out, _ = jax_scan(r, k, v, w, u, jnp.asarray(s0))
        return jnp.sum(out * do)
    g = jax.grad(f, argnums=(0, 1, 2, 3, 4))(r, k, v, w, u)
    return [torch.from_numpy(np.asarray(x)) for x in g]


def _f64_grads(r, k, v, w, u, s0, do):
    """The same gradient in float64 (autograd of the port's plain scan)."""
    leaves = [torch.from_numpy(x).double().requires_grad_()
              for x in (r, k, v, w, u)]
    out, _ = tref.rwkv6_scan_ref(*leaves, torch.from_numpy(s0).double())
    return torch.autograd.grad(out, leaves, torch.from_numpy(do).double())


CASES = {"d16": (2, 2, 37, 16, False), "d64": (1, 2, 40, 64, False),
         "d128": (1, 1, 20, 128, False), "zero": (1, 2, 33, 64, True),
         "one_chunk": (1, 1, 16, 64, False), "short": (2, 1, 17, 32, False)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_form_matches_jax_grad_and_float64(case):
    B, H, S, D, zero = CASES[case]
    ins = _inputs(B, H, S, D, seed=sorted(CASES).index(case), zero=zero)
    got = emulate_all(*(torch.from_numpy(x) for x in ins))
    for name, g, want, want64 in zip(("dr", "dk", "dv", "dw", "du"), got,
                                     _jax_grads(*ins), _f64_grads(*ins)):
        scale = float(want64.abs().max())
        assert g.shape == want.shape, name
        assert float((g - want).abs().max()) <= TOL * scale, (case, name)
        assert float((g.double() - want64).abs().max()) <= TOL * scale, \
            (case, name)


def test_zero_decays_reach_dw_without_a_division():
    """With w = 0 the state before the step cannot be recovered from the
    one after; the form re-derives it from the chunk's checkpoint, so dw
    at a zero decay is the plain gradient's (finite, non-zero)."""
    ins = _inputs(1, 1, 33, 64, seed=7, zero=True)
    got = emulate_all(*(torch.from_numpy(x) for x in ins))
    want = _f64_grads(*ins)
    dw, dw64 = got[3][0, 0, 5:10], want[3][0, 0, 5:10]
    assert torch.isfinite(dw).all() and float(dw64.abs().max()) > 0
    assert float((dw.double() - dw64).abs().max()) <= TOL * float(
        want[3].abs().max())


def test_checkpoints_are_the_forward_states():
    """The replay's checkpoint of chunk ch is the state after the first
    16 ch steps, S_0 for chunk 0 (and S_0 != 0 here)."""
    r, k, v, w, u, s0, do = (torch.from_numpy(x)
                             for x in _inputs(1, 1, 40, 16, seed=3))
    st = s0[0, 0].clone()
    for t in range(40):
        if t % C == 0:
            want = tref.rwkv6_scan_ref(r[:, :, :t], k[:, :, :t],
                                       v[:, :, :t], w[:, :, :t], u,
                                       s0)[1][0, 0] if t else s0[0, 0]
            assert torch.allclose(st, want, atol=1e-6, rtol=0)
        st = _fma(w[0, 0, t][:, None], st,
                  k[0, 0, t][:, None] * v[0, 0, t][None, :])
    assert float(s0.abs().max()) > 0


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_plan_is_a_function_of_the_shape(D):
    for S in (1, 16, 17, 1000, 1024):
        p = rkb.plan(4, 64, S, D)
        assert p == rkb.plan(4, 64, S, D)
        assert p.form == "cluster" and p.keys == KB and p.chunk == C
        assert p.cluster * p.keys == D and 1 <= p.cluster <= 8
        assert p.threads == 2 * D and p.threads % 32 == 0
        assert p.checkpoints == math.ceil(S / C)


def test_plan_of_the_rwkv6_train_shape():
    p = rkb.plan(4, 64, 1024, 64)
    assert (p.cluster, p.threads, p.checkpoints) == (4, 128, 64)
    # a block per 16 keys of each (batch, head): 1024 blocks of 128
    assert 4 * 64 * p.cluster == 1024


@pytest.mark.parametrize("D", [8, 24, 48, 256])
def test_plan_refuses_other_head_dims(D):
    with pytest.raises(ValueError, match="head dim"):
        rkb.plan(1, 1, 16, D)

"""The rounding points of K1b's bf16 form (``csrc/flash_attention_bwd.cu``,
the tensor-core passes), emulated in PyTorch on the CPU and held against
``jax.grad`` of the JAX package's plain attention in float32.

The bf16 form computes scores, the softmax, dP = dO V^T and delta =
sum_j P_ij dP_ij in float32 from float32 P and dP, delta around a pivot
(pv_i, the dP at row i's top score, and r_i = sum_j P_ij (dP_ij - pv_i)),
and dS = P ((dP - pv) - r) in float32; it rounds P and dS to bf16 (the
tensor cores' operands) before the products dV = P^T dO, dK = scale dS^T Q
and dQ = scale dS K, whose sums are float32, and rounds dq, dk, dv to bf16
at the store.  ``emulate`` does the same, so the gate the smoke holds the
kernel to on the card (``chip_smoke.rowblock_rel_err`` < ``BF16_REL_TOL``)
is checked here for the design's arithmetic: in the smoke's regime (randn
q, k, v, dO) against ``jax.grad`` in float32, and in llama's near-argmax
one at its random init (scores of std ~100) against the same function's
gradient in float64.  There a float32 gradient is itself no reference: in
a short last row block whose rows are all near one-hot (dS a difference of
nearly equal dP and delta), ``jax.grad``'s float32 dq misses the gate
against the float64 one, while the form, taking delta around a pivot,
stays within it (``python tests/test_torch_k1b_rounding.py`` prints both).
Inputs are made with numpy from a seed and rounded to bf16 once; every
side then reads the same values.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jax_attention


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def emulate(q, k, v, do, causal: bool, window: int, rnd=_bf16):
    """dq, dk, dv of the bf16 form's arithmetic on float32 tensors in the
    kernel layout (q, dO: (B,Hq,S,D); k, v: (B,Hkv,S,D)), rounded to bf16
    at the store and returned as float32.  ``rnd`` is the rounding at the
    form's three points (P and dS before their products, the stores)."""
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    scale = 1.0 / math.sqrt(D)
    kq, vq = (t.repeat_interleave(G, 1) for t in (k, v))
    i = torch.arange(S)
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window > 0:
        mask &= i[None, :] > i[:, None] - window
    s = (torch.einsum("bhqd,bhkd->bhqk", q, kq) * scale).masked_fill(
        ~mask, -math.inf)
    # the form keeps each row's max m and sum l, not m + log l: P = exp(s
    # - m) / l sums to 1 to float32 rounding, where exp(s - lse) loses
    # lse's last bit (~3e-5 at scores of a few hundred), which dS = P (dP
    # - delta) turns into O(1) of a row block's dq in the near-argmax case
    p = torch.softmax(s, -1)                                  # f32
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vq)              # f32
    # delta = pv + r around the dP at each row's top score: there dP - pv is
    # exactly 0, so that score's dS = -P r has no cancellation
    pv = dp.gather(-1, s.argmax(-1, keepdim=True))
    r = (p * (dp - pv)).sum(-1, keepdim=True)                 # f32 P, dP
    ds = p * ((dp - pv) - r)                                  # f32
    pb, dsb = rnd(p), rnd(ds)                                 # the operands
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", dsb, kq)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", dsb, q)
    dv = torch.einsum("bhqk,bhqd->bhkd", pb, do)
    dk, dv = (t.unflatten(1, (-1, G)).sum(2) for t in (dk, dv))
    return tuple(rnd(t) for t in (dq, dk, dv))


def _inputs(seed, B, Hq, Hkv, S, D, qk_std):
    rs = np.random.RandomState(seed)

    def draw(H, std=1.0):
        return _bf16(torch.tensor(rs.standard_normal((B, H, S, D)) * std,
                                  dtype=torch.float32))
    # scores q.k / sqrt(D) have std qk_std**2 for q, k of std qk_std
    return draw(Hq, qk_std), draw(Hkv, qk_std), draw(Hkv), draw(Hq)


def _f64_grads(q, k, v, do, causal, window):
    """The gradient of the JAX package's plain attention, its arithmetic
    in float64 (that function casts to float32)."""
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    qq, kk, vv = leaves
    kk, vv = (t.repeat_interleave(G, 1) for t in (kk, vv))
    i = torch.arange(S)
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window > 0:
        mask &= i[None, :] > i[:, None] - window
    s = torch.einsum("bhqd,bhkd->bhqk", qq, kk) / math.sqrt(D)
    o = torch.einsum("bhqk,bhkd->bhqd",
                     torch.softmax(s.masked_fill(~mask, -math.inf), -1), vv)
    return torch.autograd.grad(o, leaves, do.double())


def _jax_grads(q, k, v, do, causal, window):
    _, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, causal, window),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    return tuple(torch.tensor(np.asarray(g))
                 for g in vjp(jnp.asarray(do.numpy())))


# (causal, window): causal, a window biting, none
MASKS = [(True, 0), (True, 48), (False, 0)]
# (B, Hq, Hkv, S, D): GQA G = 4 and G = 1, ragged S (not a multiple of the
# kernel's 64- and 128-row tiles), D = 32 and 64
SHAPES = [(1, 8, 2, 160, 64), (2, 4, 1, 100, 32), (1, 2, 2, 200, 32)]
# randn (the smoke's cases) and scores of std ~100 (llama's near-argmax
# softmax at its random init, the train phase's gate 1)
REGIMES = {"randn": 1.0, "near_argmax": 10.0}


def errors(shape, causal: bool, window: int, regime: str) -> dict:
    """The emulated form's dq, dk, dv (``chip_smoke.rowblock_rel_err``)
    against the regime's reference, on one case's seeded inputs."""
    q, k, v, do = _inputs(sum(shape) + 7 * window + int(causal), *shape,
                          REGIMES[regime])
    got = emulate(q, k, v, do, causal, window)
    assert all(np.isfinite(g.numpy()).all() for g in got)
    want = (_jax_grads if regime == "randn" else _f64_grads)(
        q, k, v, do, causal, window)
    return {n: SMOKE.rowblock_rel_err(g, w.float())
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_form_rounding_within_the_smoke_gate(shape, causal, window,
                                                  regime):
    errs = errors(shape, causal, window, regime)
    assert max(errs.values()) < SMOKE.BF16_REL_TOL, errs


def test_emulation_without_rounding_is_the_plain_gradient():
    """With no bf16 rounding the emulation is the gradient itself: its
    float32 dq, dk, dv match ``jax.grad`` to float32 rounding, so the
    errors above are the bf16 form's and not the emulation's; and the
    float64 gradient is ``jax.grad``'s to float32 rounding."""
    q, k, v, do = _inputs(3, 1, 8, 2, 100, 64, 1.0)
    want = _jax_grads(q, k, v, do, True, 48)
    for got in (emulate(q, k, v, do, True, 48, rnd=lambda x: x),
                _f64_grads(q, k, v, do, True, 48)):
        for g, w in zip(got, want):
            assert float((g.float() - w).abs().max()) \
                <= 1e-5 * float(w.abs().max())


if __name__ == "__main__":
    # the worst error of each gradient over every case, by regime:
    # JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_k1b_rounding.py
    for regime in sorted(REGIMES):
        worst = {}
        for shape in SHAPES:
            for causal, window in MASKS:
                for n, e in errors(shape, causal, window, regime).items():
                    worst[n] = max(worst.get(n, 0.0), e)
        print(regime, {n: round(e, 5) for n, e in worst.items()})
    # near-argmax: how far jax.grad's float32 gradient itself lies from the
    # float64 one (why that regime is held to float64)
    worst = {}
    for shape in SHAPES:
        for causal, window in MASKS:
            q, k, v, do = _inputs(sum(shape) + 7 * window + int(causal),
                                  *shape, REGIMES["near_argmax"])
            for n, g, w in zip(("dq", "dk", "dv"),
                               _jax_grads(q, k, v, do, causal, window),
                               _f64_grads(q, k, v, do, causal, window)):
                worst[n] = max(worst.get(n, 0.0),
                               SMOKE.rowblock_rel_err(g, w.float()))
    print("near_argmax, jax.grad float32 against float64",
          {n: round(e, 5) for n, e in worst.items()})

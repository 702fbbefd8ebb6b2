"""The port's loss and gradients against ``jax.value_and_grad`` of the
JAX package's ``loss_fn``, for each of the ten configs at
``reduced(max_d_model=128)`` in float32 on the CPU, through the plain path
(``attn_impl="xla"``) and the kernel path (``"pallas"``: on the CPU the
autograd ``Function``s of K1, K2 and K3 with their plain backward); and
each ``Function``'s CPU backward against autograd of its plain version,
with the contracts it raises on.

Gradients are compared, not parameters after an AdamW step: the first
Adam step moves every parameter by about lr whatever its gradient's size,
so a tiny gradient that rounds apart could move a parameter by 2 lr.
Weights come from the JAX ``init_params`` and reach the port through
``params_from_numpy``; the batch is ``data.pipeline.batch_for``'s, the
same NumPy arrays for both.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import batch_for as jax_batch_for
from repro.models import init_params as jax_init_params
from repro.models.model import loss_fn as jax_loss_fn
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import rmsnorm_bwd as rmsb
from repro_torch.kernels import rwkv6_scan_bwd as rwkvb
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import batch_tensors, loss_fn
from repro_torch.train.train_step import trainable

# the loss: float32 sums in another order
LOSS_TOL = 1e-5
# each parameter's gradient: max abs error over its largest |value|
# (outside whisper's encoder the worst is ~3e-5)
GRAD_REL_TOL = 2e-3
# whisper's encoder, whose gradient reaches it through the decoder's cross
# attention and its own near-argmax bidirectional softmax at this random
# init: float32 is exact there only to ~1e-2 (the JAX package's own
# float32 gradient of enc.0.ln1 is 9.3e-3 of its largest value off the
# port's float64 gradient, the port's float32 one 4.7e-3)
ENC_GRAD_REL_TOL = 2e-2


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    jcfg = jax_get_config(arch).reduced(max_d_model=128)
    params, _ = jax_init_params(jcfg, jax.random.PRNGKey(0))
    nb = jax_batch_for(jcfg, 2, 16, seed=1)
    nb["labels"][0, :3] = -1  # masked labels
    (l, m), g = jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, jcfg, b), has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in nb.items()})
    return (jax.tree.map(np.asarray, params), nb, float(l),
            {k: float(v) for k, v in m.items()}, jax.tree.map(np.asarray, g))


def _jax_leaf(tree, name):
    """The JAX tree's entry for a port parameter name: ``blocks.3.wq`` is
    layer 3 of the stacked ``blocks/wq``."""
    parts = name.split(".")
    if len(parts) == 3:
        return tree[parts[0]][parts[2]][int(parts[1])]
    return tree[name]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_grads_match_jax(arch, impl):
    params, nb, want_loss, want_m, want_g = _jax_run(arch)
    cfg = dataclasses.replace(get_config(arch).reduced(max_d_model=128),
                              attn_impl=impl)
    model = params_from_numpy(params, cfg, device="cpu")
    ps = trainable(model)
    loss, m = loss_fn(model, cfg, batch_tensors(nb, cfg, "cpu"))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - want_loss) < LOSS_TOL
    assert abs(m["aux"].item() - want_m["aux"]) < LOSS_TOL
    assert abs(m["ce"].item() - want_m["ce"]) < LOSS_TOL
    grads = torch.autograd.grad(loss, list(ps.values()), allow_unused=True)
    for (name, p), g in zip(ps.items(), grads):
        want = _jax_leaf(want_g, name)
        got = np.zeros(p.shape, np.float32) if g is None else g.numpy()
        assert got.shape == want.shape, name
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
        tol = ENC_GRAD_REL_TOL if name.startswith("enc.") else GRAD_REL_TOL
        assert err < tol, (name, err)


# ---------------------------------------------------------------------------
# the Functions' CPU plumbing
# ---------------------------------------------------------------------------

def _t(rs, *shape, scale=1.0, dtype=torch.float32):
    return torch.tensor(rs.standard_normal(shape).astype(np.float32)
                        * scale).to(dtype).requires_grad_()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0),
                                           (False, 4)])
def test_flash_attention_function_backward(dtype, causal, window):
    """Model layout in and out; gradients in q's dtype equal autograd of
    ``ref.flash_attention_ref`` on the kernel layout."""
    rs = np.random.RandomState(0)
    q, k, v = _t(rs, 2, 11, 4, 32, dtype=dtype), \
        _t(rs, 2, 11, 2, 32, dtype=dtype), _t(rs, 2, 11, 2, 32, dtype=dtype)
    dout = torch.tensor(rs.standard_normal((2, 11, 4, 32)),
                        dtype=torch.float32).to(dtype)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert out.is_contiguous() and out.shape == q.shape
    got = torch.autograd.grad(out, (q, k, v), dout)
    want_o = ref.flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                                     causal, window)
    want = torch.autograd.grad(want_o, (q, k, v), dout.transpose(1, 2))
    assert torch.equal(out, want_o.transpose(1, 2))
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,sdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32)])
def test_rmsnorm_function_backward(dtype, sdtype):
    rs = np.random.RandomState(1)
    x = _t(rs, 3, 5, 64, dtype=dtype)
    scale = _t(rs, 64, scale=0.1, dtype=sdtype)
    dy = torch.tensor(rs.standard_normal((3, 5, 64)),
                      dtype=torch.float32).to(dtype)
    y = ops.rmsnorm(x, scale, 1e-5)
    gx, gs = torch.autograd.grad(y, (x, scale), dy)
    wx, ws = torch.autograd.grad(ref.rmsnorm_ref(x, scale, 1e-5), (x, scale),
                                 dy)
    assert gx.dtype == dtype and gs.dtype == sdtype
    assert torch.equal(gx, wx) and torch.equal(gs, ws)


def test_rwkv6_function_backward_and_its_contract():
    """Gradients for r, k, v, w and u (w float32, u bf16 as the bf16
    model passes them) from a non-zero initial state; none for either
    state: a state that requires grad raises, and so does asking for the
    new state's gradient."""
    rs = np.random.RandomState(2)
    B, S, H, D = 2, 7, 2, 16
    r, k, v = (_t(rs, B, S, H, D, scale=0.5) for _ in range(3))
    w = torch.sigmoid(torch.tensor(rs.standard_normal((B, S, H, D)),
                                   dtype=torch.float32)).requires_grad_()
    u = _t(rs, H, D, scale=0.3, dtype=torch.bfloat16)
    state = torch.tensor(rs.standard_normal((B, H, D, D)) * 0.2,
                         dtype=torch.float32)
    dout = torch.tensor(rs.standard_normal((B, S, H, D)), dtype=torch.float32)
    out, new = ops.rwkv6_scan(r, k, v, w, u, state)
    got = torch.autograd.grad(out, (r, k, v, w, u), dout, retain_graph=True)
    want_o, want_s = ref.rwkv6_scan_ref(
        *(t.transpose(1, 2) for t in (r, k, v, w)), u, state)
    want = torch.autograd.grad(want_o, (r, k, v, w, u), dout.transpose(1, 2))
    assert torch.equal(new, want_s)
    for a, b, t in zip(got, want, (r, k, v, w, u)):
        assert a.dtype == t.dtype and a.shape == t.shape
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="new state"):
        torch.autograd.grad((out * dout).sum() + new.sum(), (r,))
    with pytest.raises(ValueError, match="initial"):
        ops.rwkv6_scan(r, k, v, w, u, state.clone().requires_grad_())


def test_kernel_bindings_take_cuda_tensors_only():
    """On a CPU tensor the backward kernels raise; nothing falls back."""
    x = torch.ones(4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        rmsb.rmsnorm_bwd(x, torch.ones(32), x)
    q = torch.ones(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fab.flash_attention_bwd(q, q, q, q)
    r = torch.ones(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        rwkvb.rwkv6_scan_bwd(r, r, r, r, torch.ones(2, 16),
                             torch.zeros(1, 2, 16, 16), r)

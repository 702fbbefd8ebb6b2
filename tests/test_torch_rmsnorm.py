"""The port's RMSNorm (K3) against the JAX package's, on the CPU.

On a CPU tensor ``ops.rmsnorm`` takes the kernel's plain version
(``repro_torch.kernels.ref.rmsnorm_ref``); the JAX side runs its Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` does.  The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py``.  The kernel path of ``forward`` normalises through
``ops.rmsnorm``: 2 per layer + 1 per forward, none on the plain path or in
``decode_step``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as trms
from repro_torch.models import model as tm
from repro_torch.models.cache import init_cache
from repro_torch.models.convert import params_from_numpy

# the JAX property test's tolerance (tests/test_kernels.py) in float32; in
# bfloat16, one bf16 ulp of each row's largest value: both sides compute
# in float32 and round once
F32_TOL = 1e-5
BF16_ROW_ULP = 2.0 ** -7
MODEL_TOL = 2e-3
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(n, d, seed, scale=1.0):
    rs = np.random.RandomState(seed)
    x = (scale * rs.standard_normal((n, d))).astype(np.float32)
    s = (1.0 + 0.1 * rs.standard_normal(d)).astype(np.float32)
    return x, s


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _both(x, s, dtype, sdtype):
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    js = jnp.asarray(s).astype(getattr(jnp, sdtype))
    return (jx, js), (torch.from_numpy(x).to(TORCH_DT[dtype]),
                      torch.from_numpy(s).to(TORCH_DT[sdtype]))


def _row_rel_err(got, want):
    err = np.abs(_f32(got) - _f32(want)).max(-1)
    return float((err / np.maximum(np.abs(_f32(want)).max(-1), 1e-30)).max())


# N not a multiple of the TPU kernel's 256-row block: the JAX wrapper pads,
# the port does not
@pytest.mark.parametrize("n,d", [(8, 128), (300, 256), (45, 96), (513, 64)])
def test_rmsnorm_f32_matches_pallas(n, d):
    x, s = _inputs(n, d, seed=n)
    (jx, js), (tx, ts) = _both(x, s, "float32", "float32")
    got = tops.rmsnorm(tx, ts)
    want = jops.rmsnorm(jx, js, impl="pallas")
    assert got.dtype == torch.float32 and got.shape == (n, d)
    assert float(np.abs(_f32(got) - _f32(want)).max()) < F32_TOL


@pytest.mark.parametrize("n,d,sdtype", [(300, 256, "bfloat16"),
                                        (45, 96, "float32"),
                                        (7, 512, "bfloat16")])
def test_rmsnorm_bf16_rows_match_pallas(n, d, sdtype):
    x, s = _inputs(n, d, seed=d)
    (jx, js), (tx, ts) = _both(x, s, "bfloat16", sdtype)
    got = tops.rmsnorm(tx, ts)
    want = jops.rmsnorm(jx, js, impl="pallas")
    assert got.dtype == torch.bfloat16 and got.shape == (n, d)
    assert _row_rel_err(got, want) <= BF16_ROW_ULP


def test_rmsnorm_eps_matters_on_small_rows():
    """Rows of magnitude 1e-3 (mean square 1e-6 against eps 1e-5): the
    port follows the Pallas kernel where eps dominates."""
    x, s = _inputs(40, 128, seed=3, scale=1e-3)
    (jx, js), (tx, ts) = _both(x, s, "float32", "float32")
    got = _f32(tops.rmsnorm(tx, ts))
    assert float(np.abs(got - _f32(jops.rmsnorm(jx, js,
                                                impl="pallas"))).max()) \
        < F32_TOL
    no_eps = _f32(tops.rmsnorm(tx, ts, eps=0.0))
    assert float(np.abs(got - no_eps).max()) > 100 * F32_TOL


def test_rmsnorm_leading_dims_and_strided_rows():
    x, s = _inputs(24, 64, seed=5)
    (jx, js), (tx, ts) = _both(x, s, "float32", "float32")
    want = _f32(jops.rmsnorm(jx.reshape(2, 3, 4, 64), js, impl="pallas"))
    got = tops.rmsnorm(tx.reshape(2, 3, 4, 64), ts)
    assert got.shape == (2, 3, 4, 64)
    assert float(np.abs(_f32(got) - want).max()) < F32_TOL
    # the kernel reads a strided set of rows in place
    wide = torch.zeros(24, 96)
    view = wide[:, 16:80]
    assert trms._rows(view) == (24, 96)
    assert trms._rows(tx.reshape(2, 3, 4, 64)) == (24, 64)
    with pytest.raises(ValueError, match="strided set of rows"):
        trms._rows(tx.reshape(2, 12, 64).transpose(0, 1))


def test_kernel_wrapper_rejects_cpu_tensors_and_bad_dtypes():
    x, s = _inputs(4, 32, seed=0)
    tx, ts = torch.from_numpy(x), torch.from_numpy(s)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        trms.rmsnorm(tx, ts)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trms.rmsnorm(tx.double(), ts)
    with pytest.raises(ValueError, match="scale must be"):
        trms.rmsnorm(tx, ts.to(torch.bfloat16))
    with pytest.raises(ValueError, match="want x"):
        trms.rmsnorm(tx, ts[:16])


# ---------------------------------------------------------------------------
# the norm path of forward
# ---------------------------------------------------------------------------

def _cfg(arch, **kw):
    cfg = jax_get_config(arch).reduced()
    if arch == "llama3.2-1b":
        kw.setdefault("n_kv_heads", 2)
    return dataclasses.replace(cfg, **kw)


def _count_norms(monkeypatch):
    calls = []
    real = tops.rmsnorm

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tops, "rmsnorm", counted)
    return calls


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b"])
def test_kernel_path_forward_normalises_through_ops(arch, monkeypatch):
    """2 layers: the kernel-path forward matches the JAX package's and
    calls ``ops.rmsnorm`` 2 * 2 + 1 = 5 times on (B, S, d); the plain
    path and ``decode_step`` call it never."""
    cfg = _cfg(arch, attn_impl="pallas")
    params, _ = jax_init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 12))
    calls = _count_norms(monkeypatch)
    got, _ = tm.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    assert calls == [(2, 12, cfg.d_model)] * (2 * cfg.n_layers + 1)
    want, _ = jax_forward(params, cfg, {"tokens": jnp.asarray(toks)})
    assert float(np.abs(_f32(got) - _f32(want)).max()) < MODEL_TOL

    calls.clear()
    plain = dataclasses.replace(cfg, attn_impl="xla")
    tm.forward(model, plain, {"tokens": torch.from_numpy(toks)})
    cache = init_cache(cfg, 2, 16, device="cpu")
    tm.decode_step(model, cfg, cache, torch.from_numpy(toks[:, 0]), 0)
    assert calls == []

"""The port's flash attention against the JAX package's, on the CPU.

On a CPU tensor the port's ``ops.flash_attention`` takes the kernel's plain
version (``repro_torch.kernels.ref``); the JAX side runs its Pallas kernel
in interpret mode, as ``tests/test_kernels.py`` does.  The CUDA kernel
itself is held against the same plain version on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# the JAX package's kernel tolerances (tests/test_kernels.py)
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B, S, Hq, Hkv, D, seed):
    """Model-layout q (B,S,Hq,D), k/v (B,S,Hkv,D) as float32 numpy."""
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rs.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rs.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def _both(arrays, dtype):
    """The same values in both frameworks (bf16 rounding is identical)."""
    js = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    ts = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrays]
    return js, ts


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
    (2, 2, 2, 384, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96), (False, 0)])
def test_flash_attention_sweep(B, Hq, Hkv, S, D, dtype, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, Hq, Hkv, D, 0), dtype)
    out = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == TORCH_DT[dtype] and out.shape == (B, S, Hq, D)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                impl="pallas")
    err = float(np.max(np.abs(_f32(out) - _f32(want))))
    assert err < TOL[dtype], err
    # the plain version in kernel layout is what ops dispatched to
    kl = tref.flash_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                                  tv.transpose(1, 2), causal, window)
    assert torch.equal(kl.transpose(1, 2), out)


def test_flash_ragged_causal_matches_jax_wrapper():
    """S=100 is no tile multiple: the port pads nothing, the JAX wrapper
    pads to 128; for causal calls the two agree."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 100, 4, 2, 32, 1),
                                       "float32")
    out = tops.flash_attention(tq, tk, tv, causal=True)
    want = jops.flash_attention(jq, jk, jv, causal=True, impl="pallas")
    assert float(np.max(np.abs(_f32(out) - _f32(want)))) < 2e-4


def test_flash_ragged_noncausal_matches_jax_oracle():
    """Non-causal ragged S is held against the JAX oracle, not the JAX
    wrapper: ``repro/kernels/ops.py:33-41`` pads K/V with zero keys that
    enter a non-causal softmax, so that wrapper is off by ~0.1 here.  The
    port masks the ragged edge and does not copy that behaviour."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 100, 4, 2, 32, 2),
                                       "float32")
    out = tops.flash_attention(tq, tk, tv, causal=False)
    want = jref.flash_attention_ref(*(jnp.swapaxes(t, 1, 2)
                                      for t in (jq, jk, jv)), causal=False)
    want = jnp.swapaxes(want, 1, 2)
    assert float(np.max(np.abs(_f32(out) - _f32(want)))) < 2e-4


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flash_attention_rowsum_property(seed):
    """Softmax rows sum to 1 => with V == all-ones the output is ones."""
    q, k, _ = _inputs(1, 128, 2, 2, 32, seed)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    out = tops.flash_attention(tq, tk, torch.ones_like(tk), causal=True)
    assert float((out - 1.0).abs().max()) < 1e-5


def test_kernel_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 64, 2, 1, 64, 0))
    launches = tfa.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2))
    assert tfa.LAUNCHES == launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96), (False, 0)])
def test_ops_flash_attention_returns_model_layout(dtype, causal, window):
    """``ops.flash_attention`` returns a contiguous (B,S,Hq,D) tensor, the
    layout the kernel writes in place on the card, with the JAX package's
    values, so the output projection flattens the heads without a copy."""
    B, S, Hq, Hkv, D = 2, 256, 4, 2, 64
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, Hq, Hkv, D, 3), dtype)
    out = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.shape == (B, S, Hq, D) and out.is_contiguous()
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                impl="pallas")
    err = float(np.max(np.abs(_f32(out) - _f32(want))))
    assert err < TOL[dtype], err


def _bf16_view(kind):
    """(tensor, accepted by TMA?) for one layout the bf16 kernel may get."""
    B, S, Hq, Hkv, D = 2, 48, 4, 2, 64
    bf = torch.bfloat16
    if kind == "model_q":  # ops' transposed views of (B,S,H,D) tensors
        return torch.empty(B, S, Hq, D, dtype=bf).transpose(1, 2), True
    if kind == "model_kv_d32":
        return torch.empty(B, S, Hkv, 32, dtype=bf).transpose(1, 2), True
    if kind == "model_d128":
        return torch.empty(B, S, Hq, 128, dtype=bf).transpose(1, 2), True
    if kind == "kernel_layout":
        return torch.empty(B, Hq, S, D, dtype=bf), True
    if kind == "extent_one_odd_stride":  # a dim of extent 1 is never stepped
        t = torch.empty(B * S * D, dtype=bf)
        return t.as_strided((B, 1, S, D), (S * D, 7, D, 1)), True
    if kind == "misaligned_2_bytes":
        flat = torch.empty(B * Hq * S * D + 64, dtype=bf)
        return flat[1:1 + B * Hq * S * D].view(B, Hq, S, D), False
    if kind == "misaligned_8_bytes":
        flat = torch.empty(B * Hq * S * D + 64, dtype=bf)
        return flat[4:4 + B * Hq * S * D].view(B, Hq, S, D), False
    if kind == "stride_not_16_bytes":  # rows of 68 bf16 = 136 bytes
        t = torch.empty(B, S, Hq, 68, dtype=bf)[..., :D]
        return t.transpose(1, 2), False
    if kind == "head_dim_strided":
        return torch.empty(B, Hq, S, 2 * D, dtype=bf)[..., ::2], False
    raise KeyError(kind)


@pytest.mark.parametrize("kind", [
    "model_q", "model_kv_d32", "model_d128", "kernel_layout",
    "extent_one_odd_stride", "misaligned_2_bytes", "misaligned_8_bytes",
    "stride_not_16_bytes", "head_dim_strided"])
def test_tma_layout_rule(kind):
    """The bf16 kernel's layout rule (TMA): D contiguous, a 16-byte aligned
    pointer and every other stride a multiple of 16 bytes."""
    t, accepted = _bf16_view(kind)
    err = tfa.tma_layout_error(t.shape, t.stride(), t.element_size(),
                               t.data_ptr())
    assert (err is None) == accepted, err

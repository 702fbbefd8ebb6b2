"""The port's llama3.2-1b against the JAX package's, in float32 on the CPU.

Reduced config with two KV heads, so that GQA grouping is exercised
(``reduced()`` alone makes n_kv_heads == n_heads).  Weights come from the
JAX ``init_params`` and reach the port through ``params_from_numpy``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config, list_archs
from repro_torch.models import model as tm
from repro_torch.models.attention import update_cache
from repro_torch.models.cache import init_cache
from repro_torch.models.convert import params_from_numpy

# the repo's decode/forward tolerance (tests/test_decode_consistency.py)
TOL = 2e-3


def _cfg(**kw):
    return dataclasses.replace(jax_get_config("llama3.2-1b").reduced(),
                               n_kv_heads=2, **kw)


def _pair(cfg):
    params, _ = jax_init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return params, model


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))


def test_config_is_a_copy_of_the_jax_config():
    from repro.models.config import ModelConfig as JaxModelConfig
    from repro_torch.models.config import ModelConfig
    assert ([f.name for f in dataclasses.fields(ModelConfig)]
            == [f.name for f in dataclasses.fields(JaxModelConfig)])
    for name in ("llama3.2-1b", "rwkv6-7b"):
        assert (dataclasses.asdict(get_config(name))
                == dataclasses.asdict(jax_get_config(name)))
    assert list_archs() == ["llama3.2-1b", "rwkv6-7b"]
    for name in ("hymba-1.5b", "no-such-model"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            get_config(name)


@pytest.mark.parametrize("change", [{"family": "moe"}, {"qkv_bias": True},
                                    {"family": "hybrid"}])
def test_unported_options_raise(change):
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), **change)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tm.init_params(cfg, device="cpu")


def test_init_params_copies_param_factory_scales():
    cfg = get_config("llama3.2-1b").reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.init_params(cfg)  # the card is the default device
    model = tm.init_params(cfg, seed=3, device="cpu")
    blk = model.blocks[0]
    assert torch.equal(model.final_norm, torch.ones(cfg.d_model))
    assert torch.equal(blk.ln1, torch.ones(cfg.d_model))
    for t, want in ((model.embed, 0.02),
                    (blk.wq, cfg.n_heads ** -0.5),       # fan_in = shape[-2]
                    (blk.wo, cfg.head_dim ** -0.5),
                    (blk.w_gate, cfg.d_model ** -0.5),
                    (blk.w_down, cfg.d_ff ** -0.5)):
        assert abs(float(t.std()) / want - 1) < 0.05
    again = tm.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(again.blocks[1].wv, model.blocks[1].wv)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("window", [0, 4])
def test_forward_matches_jax(impl, window):
    cfg = _cfg(attn_impl=impl)
    params, model = _pair(cfg)
    toks = _tokens(cfg, 2, 12)
    want, _ = jax_forward(params, cfg, {"tokens": jnp.asarray(toks)},
                          window=window)
    got, aux = tm.forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                          window=window)
    assert got.shape == want.shape and float(aux) == 0.0
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL


def test_untied_embeddings_match_jax():
    """A separate ``unembed`` (d, V), as rwkv6 has, on the dense family."""
    cfg = _cfg(tie_embeddings=False)
    params, model = _pair(cfg)
    assert tuple(model.unembed.shape) == (cfg.d_model, cfg.vocab_size)
    toks = _tokens(cfg, 2, 8)
    want, _ = jax_forward(params, cfg, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL


def test_decode_step_matches_jax():
    cfg = _cfg()
    params, model = _pair(cfg)
    B, S = 2, 10
    toks = _tokens(cfg, B, S, seed=1)
    jcache, _ = jax_init_cache(cfg, B, S + 2)
    cache = init_cache(cfg, B, S + 2, device="cpu")
    for i in range(S):
        want, jcache = jax_decode_step(params, cfg, jcache,
                                       jnp.asarray(toks[:, i]), jnp.int32(i))
        got, cache = tm.decode_step(model, cfg, cache,
                                    torch.from_numpy(toks[:, i]), i)
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL
    for name in ("k", "v"):  # f32 rounding, relative to |K|, |V| ~ 50
        want = np.asarray(jcache[name])
        err = np.abs(cache[name].numpy() - want).max()
        assert err < 1e-5 * np.abs(want).max(), (name, err)


@pytest.mark.parametrize("window", [0, 4])
def test_decode_matches_forward(window):
    """Token-by-token decode reproduces forward's logits (the port's own
    KV-cache invariant, as tests/test_decode_consistency.py checks it for
    the JAX package)."""
    cfg = _cfg(sliding_window=window)
    _, model = _pair(cfg)
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=2))
    full, _ = tm.forward(model, cfg, {"tokens": toks})
    cache = init_cache(cfg, B, S + 4, device="cpu")
    dec = []
    for i in range(S):
        logits, cache = tm.decode_step(model, cfg, cache, toks[:, i], i)
        dec.append(logits)
    assert float((torch.stack(dec, 1) - full).abs().max()) < TOL


@pytest.mark.parametrize("pos", [0, 3, 7])
def test_seq_sharded_update_equivalent(pos):
    """The iota/select cache write equals the slice write."""
    rs = np.random.RandomState(pos)
    k, v = (torch.from_numpy(rs.standard_normal((2, 8, 2, 4))
                             .astype(np.float32)) for _ in range(2))
    k1, v1 = (torch.from_numpy(rs.standard_normal((2, 1, 2, 4))
                               .astype(np.float32)) for _ in range(2))
    a = update_cache(k.clone(), v.clone(), k1, v1, pos, seq_sharded=False)
    b = update_cache(k.clone(), v.clone(), k1, v1, pos, seq_sharded=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0][:, pos:pos + 1], k1)
    assert torch.equal(a[0][:, :pos], k[:, :pos])


def test_fp8_kv_cache_dtype():
    cfg = _cfg(kv_cache_dtype="float8_e4m3fn")
    cache = init_cache(cfg, 1, 8, device="cpu")
    assert cache["k"].dtype == torch.float8_e4m3fn
    assert cache["k"].shape == (cfg.n_layers, 1, 8, 2, cfg.head_dim)

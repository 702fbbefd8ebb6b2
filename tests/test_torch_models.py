"""The port's config registry (all ten of the JAX package's configs) and
its dense models against the JAX package's, in float32 on the CPU:
llama3.2-1b, tinyllama-1.1b, granite-34b (MQA) and qwen2.5-32b (QKV
bias).

The llama config is reduced with two KV heads, so that GQA grouping is
exercised (``reduced()`` alone makes n_kv_heads == n_heads).  Weights come
from the JAX ``init_params`` and reach the port through
``params_from_numpy``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
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


def _biased_pair(cfg, seed=5):
    """The JAX tree with ``bq``/``bk``/``bv`` set to seeded non-zero values
    (the JAX ``init_params`` starts them at zero, which would test
    nothing), and the port's model from that same tree."""
    params, _ = jax_init_params(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, params)
    rs = np.random.RandomState(seed)
    for name in ("bq", "bk", "bv"):
        b = tree["blocks"][name]
        tree["blocks"][name] = (rs.standard_normal(b.shape) * 0.5).astype(
            b.dtype)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, cfg, device="cpu"))


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))


def test_config_is_a_copy_of_the_jax_config():
    from repro.configs import canonical_names as jax_canonical_names
    from repro.configs import list_archs as jax_list_archs
    from repro.models.config import ModelConfig as JaxModelConfig
    from repro_torch.configs import INPUT_SHAPES, canonical_names, get_shape
    from repro_torch.models.config import ModelConfig
    assert ([f.name for f in dataclasses.fields(ModelConfig)]
            == [f.name for f in dataclasses.fields(JaxModelConfig)])
    # all ten of the JAX package's names, in its order
    assert list_archs() == jax_list_archs() and len(list_archs()) == 10
    assert canonical_names() == jax_canonical_names()
    assert get_shape("decode_32k") == INPUT_SHAPES["decode_32k"]
    assert (dataclasses.asdict(get_shape("long_500k"))
            == dataclasses.asdict(jax_get_shape("long_500k")))


@pytest.mark.parametrize("arch", [
    "whisper-tiny", "tinyllama-1.1b", "internvl2-2b", "grok-1-314b",
    "granite-34b", "llama3.2-1b", "hymba-1.5b", "qwen3-moe-235b-a22b",
    "rwkv6-7b", "qwen2.5-32b"])
def test_every_config_equals_the_jax_config(arch):
    """Each of the ten configs, by its name and by its module name."""
    want = dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_config(arch)) == want
    mod = arch.replace("-", "_").replace(".", "_")
    assert dataclasses.asdict(get_config(mod)) == want


@pytest.mark.parametrize("name", ["no-such-model", "llama3.2-70b", ""])
def test_unknown_arch_raises_key_error(name):
    """As the reference's registry does, now that every name is ported."""
    with pytest.raises(KeyError, match="unknown architecture"):
        jax_get_config(name)
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config(name)


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


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-34b"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_dense_configs_forward_match_jax(arch, impl):
    """tinyllama-1.1b (untied, GQA) and granite-34b (tied, MQA: reduced()
    keeps its one KV head) as the reference reduces them."""
    cfg = dataclasses.replace(jax_get_config(arch).reduced(), attn_impl=impl)
    if arch == "granite-34b":
        assert cfg.n_kv_heads == 1 and cfg.n_heads > 1
    params, model = _pair(cfg)
    toks = _tokens(cfg, 2, 12)
    want, _ = jax_forward(params, cfg, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape and float(aux) == 0.0
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("window", [0, 4])
def test_qkv_bias_forward_matches_jax(impl, window):
    cfg = dataclasses.replace(jax_get_config("qwen2.5-32b").reduced(),
                              n_kv_heads=2, attn_impl=impl)
    assert cfg.qkv_bias
    params, model = _biased_pair(cfg)
    assert float(model.blocks[0].bk.abs().min()) > 0
    toks = _tokens(cfg, 2, 12)
    want, _ = jax_forward(params, cfg, {"tokens": jnp.asarray(toks)},
                          window=window)
    got, _ = tm.forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                        window=window)
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL
    # the biases matter: the same weights without them give other logits
    for blk in model.blocks:
        for name in ("bq", "bk", "bv"):
            getattr(blk, name).zero_()
    unbiased, _ = tm.forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                             window=window)
    assert float(np.max(np.abs(unbiased.numpy() - np.asarray(want)))) > 1e-2


def test_qkv_bias_decode_step_matches_jax():
    cfg = dataclasses.replace(jax_get_config("qwen2.5-32b").reduced(),
                              n_kv_heads=2)
    params, model = _biased_pair(cfg)
    B, S = 2, 8
    toks = _tokens(cfg, B, S, seed=1)
    jcache, _ = jax_init_cache(cfg, B, S + 2)
    cache = init_cache(cfg, B, S + 2, device="cpu")
    for i in range(S):
        want, jcache = jax_decode_step(params, cfg, jcache,
                                       jnp.asarray(toks[:, i]), jnp.int32(i))
        got, cache = tm.decode_step(model, cfg, cache,
                                    torch.from_numpy(toks[:, i]), i)
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL
    full, _ = tm.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    assert float((got - full[:, -1]).abs().max()) < TOL


def test_qkv_bias_params_start_at_zero():
    cfg = get_config("qwen2.5-32b").reduced()
    blk = tm.init_params(cfg, seed=0, device="cpu").blocks[0]
    assert tuple(blk.bq.shape) == (cfg.n_heads, cfg.head_dim)
    assert tuple(blk.bk.shape) == tuple(blk.bv.shape) == (cfg.n_kv_heads,
                                                          cfg.head_dim)
    assert not any(float(getattr(blk, n).abs().max()) for n in
                   ("bq", "bk", "bv"))

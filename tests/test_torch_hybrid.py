"""The port's hybrid family (hymba-1.5b: attention beside a mamba mix)
against the JAX package's, in float32 on the CPU.

The config is ``reduced()`` with two KV heads, so that GQA grouping is
exercised (``reduced()`` alone leaves 4 q heads over 4 KV heads).
Weights come from the JAX ``init_params`` and reach the port through
``params_from_numpy``.  ``init_mamba`` starts ``m_alog`` and ``m_dtb`` at
zero and ``m_d`` at one; the unit tests of ``mamba_mix`` overwrite them
from a NumPy seed, so that a dropped decay, step bias or skip shows.
"""
import dataclasses
from types import SimpleNamespace

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
from repro.models import mamba as JM
from repro.serve.serve_step import Request as JaxRequest
from repro.serve.serve_step import ServingEngine as JaxServingEngine
from repro_torch.launch import serve as tlaunch
from repro_torch.models import mamba as TM
from repro_torch.models import model as tm
from repro_torch.models.cache import init_cache
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.serve_step import Request, ServingEngine

# the repo's decode/forward tolerance (tests/test_decode_consistency.py)
TOL = 2e-3
# mamba_mix: max abs error over the largest |value| of each output
MIX_TOL = 1e-5
ARCH = "hymba-1.5b"


def _cfg(**kw):
    return dataclasses.replace(jax_get_config(ARCH).reduced(), n_kv_heads=2,
                               **kw)


def _pair(cfg):
    params, _ = jax_init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return params, model


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / np.max(np.abs(want)))


def _layer(cfg, seed=3):
    """Layer 0's mamba parameters from the JAX init, with ``m_alog``,
    ``m_dtb`` and ``m_d`` drawn from ``seed``: (the JAX dict, the same as
    torch tensors on a namespace)."""
    params, _ = jax_init_params(cfg, jax.random.PRNGKey(0))
    lp = {k: np.array(v[0]) for k, v in params["blocks"].items()
          if k.startswith("m_")}
    rs = np.random.RandomState(seed)
    di = TM.d_inner(cfg)
    lp["m_alog"] = rs.uniform(-2.0, 1.0, di).astype(np.float32)
    lp["m_dtb"] = rs.uniform(-1.0, 1.0, di).astype(np.float32)
    lp["m_d"] = rs.uniform(0.5, 1.5, di).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in lp.items()},
            SimpleNamespace(**{k: torch.from_numpy(v) for k, v in lp.items()}))


def _states(cfg, B, seed=4):
    """Non-zero conv (B, K-1, Di) and SSM (B, Di, N) states."""
    rs = np.random.RandomState(seed)
    di = TM.d_inner(cfg)
    conv = rs.standard_normal((B, TM.CONV_K - 1, di)).astype(np.float32)
    ssm = rs.standard_normal((B, di, cfg.ssm_state)).astype(np.float32)
    return conv, ssm


def _x(cfg, B, S, seed=1):
    return (np.random.RandomState(seed).standard_normal(
        (B, S, cfg.d_model)) * 0.5).astype(np.float32)


# ---------------------------------------------------------------------------
# the mamba mix
# ---------------------------------------------------------------------------

def test_constants_are_the_jax_package_s():
    cfg = _cfg()
    assert TM.CONV_K == JM.CONV_K and TM.d_inner(cfg) == JM.d_inner(cfg)


@pytest.mark.parametrize("S", [1, 2, 13, 64, 100])
def test_mamba_mix_matches_jax(S):
    """Output, new conv state and new SSM state from non-zero states,
    each within ``MIX_TOL`` of its largest value; S = 1 is the decode
    step's one-step form, 13 and 100 are not powers of two."""
    cfg = _cfg()
    jp, tp = _layer(cfg)
    conv, ssm = _states(cfg, 2)
    x = _x(cfg, 2, S)
    want = JM.mamba_mix(jp, jnp.asarray(x), cfg, jnp.asarray(conv),
                        jnp.asarray(ssm))
    got = TM.mamba_mix(tp, torch.from_numpy(x), cfg, torch.from_numpy(conv),
                       torch.from_numpy(ssm))
    for g, w, name in zip(got, want, ("out", "conv", "ssm")):
        assert tuple(g.shape) == tuple(w.shape), name
        assert _rel(g.numpy(), w) < MIX_TOL, (name, _rel(g.numpy(), w))
    assert got[1].dtype == torch.float32 and got[2].dtype == torch.float32
    assert torch.equal(got[1], torch.from_numpy(
        np.concatenate([conv, _conv_input(tp, x)], 1)[:, -3:]))


def _conv_input(tp, x):
    """The conv's input: the first half of the input projection."""
    xi = torch.from_numpy(x) @ tp.m_in
    return xi[..., :xi.shape[-1] // 2].numpy()


def test_mamba_mix_chained_halves_equal_one_call():
    """The state carry: two halves, the second from the first's conv and
    SSM states, give the one call's output and states."""
    cfg = _cfg()
    jp, tp = _layer(cfg)
    conv, ssm = (torch.from_numpy(t) for t in _states(cfg, 2))
    x = torch.from_numpy(_x(cfg, 2, 40))
    whole = TM.mamba_mix(tp, x, cfg, conv, ssm)
    a = TM.mamba_mix(tp, x[:, :17], cfg, conv, ssm)
    b = TM.mamba_mix(tp, x[:, 17:], cfg, a[1], a[2])
    assert _rel(torch.cat([a[0], b[0]], 1).numpy(), whole[0].numpy()) < MIX_TOL
    assert torch.equal(b[1], whole[1])
    assert _rel(b[2].numpy(), whole[2].numpy()) < MIX_TOL
    # ... and the JAX package's halves agree with both
    ja = JM.mamba_mix(jp, jnp.asarray(x[:, :17].numpy()), cfg,
                      jnp.asarray(conv.numpy()), jnp.asarray(ssm.numpy()))
    jb = JM.mamba_mix(jp, jnp.asarray(x[:, 17:].numpy()), cfg, ja[1], ja[2])
    assert _rel(b[0].numpy(), jb[0]) < MIX_TOL
    assert _rel(b[2].numpy(), jb[2]) < MIX_TOL


@pytest.mark.parametrize("S", [1, 2, 5, 8, 31, 64, 97])
def test_log_step_scan_equals_the_recurrence(S):
    """The Hillis-Steele scan against h_t = a_t h_{t-1} + b_t step by
    step in float64, from a non-zero h0; a is shared across the state
    channels, as ``mamba_mix`` passes it."""
    rs = np.random.RandomState(S)
    a = torch.from_numpy(rs.uniform(0.2, 1.0, (2, S, 6, 1)))
    b = torch.from_numpy(rs.standard_normal((2, S, 6, 4)))
    h0 = torch.from_numpy(rs.standard_normal((2, 6, 4)))
    h, last = TM._ssm_scan(a, b.clone(), h0)
    want, prev = [], h0
    for t in range(S):
        prev = a[:, t] * prev + b[:, t]
        want.append(prev)
    want = torch.stack(want, 1)
    assert float((h - want).abs().max()) < 1e-12
    assert torch.equal(last, h[:, -1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_is_bitwise_the_jax_package_s(dtype):
    """The taps summed left to right in the working type, as the
    reference does: bitwise equal to it in both types.  ``F.conv1d``
    (float32 accumulation) rounds bfloat16 otherwise, so it would fail."""
    rs = np.random.RandomState(0)
    x, w, st = (rs.standard_normal(shape).astype(np.float32)
                for shape in ((2, 9, 64), (4, 64), (2, 3, 64)))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, want_new = JM._causal_conv(*(jnp.asarray(t, jdt)
                                       for t in (x, w, st)))
    tx, tw, tst = (torch.from_numpy(t).to(tdt) for t in (x, w, st))
    out, new = TM._causal_conv(tx, tw, tst)
    assert out.dtype == new.dtype == tdt
    assert np.array_equal(out.float().numpy(), np.asarray(want, np.float32))
    assert np.array_equal(new.float().numpy(),
                          np.asarray(want_new, np.float32))
    if dtype == "bfloat16":
        conv = torch.nn.functional.conv1d(
            torch.cat([tst, tx], 1).transpose(1, 2), tw.t()[:, None, :],
            groups=64).transpose(1, 2)
        assert not torch.equal(conv, out)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("window", [0, 4])
def test_forward_matches_jax(impl, window):
    """``attn_impl="pallas"``: the JAX side runs its Pallas kernel in
    interpret mode, the port the kernels' plain versions (a CPU tensor);
    a window of 4 bites at S = 12."""
    cfg = _cfg(attn_impl=impl)
    params, model = _pair(cfg)
    toks = _tokens(cfg, 2, 12)
    want, _ = jax_forward(params, cfg, {"tokens": jnp.asarray(toks)},
                          window=window)
    got, aux = tm.forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                          window=window)
    assert got.shape == want.shape and float(aux) == 0.0
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL


def _seeded_cache(cfg, B, S, seed=6):
    """A decode state of ``init_cache``'s layout with every entry drawn
    from ``seed``: (the JAX dict, the port's)."""
    jcache, _ = jax_init_cache(cfg, B, S)
    rs = np.random.RandomState(seed)
    arrs = {k: (rs.standard_normal(v.shape) * 0.5).astype(np.float32)
            for k, v in jcache.items()}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrs.items()})


@pytest.mark.parametrize("window", [0, 4])
def test_decode_step_matches_jax(window):
    """From a seeded cache (K/V, conv and SSM states), token by token:
    the logits and every cache entry."""
    cfg = _cfg(sliding_window=window)
    params, model = _pair(cfg)
    B, S, start = 2, 6, 5
    toks = _tokens(cfg, B, S, seed=1)
    jcache, cache = _seeded_cache(cfg, B, start + S + 1)
    for i in range(S):
        pos = start + i
        want, jcache = jax_decode_step(params, cfg, jcache,
                                       jnp.asarray(toks[:, i]),
                                       jnp.int32(pos))
        got, cache = tm.decode_step(model, cfg, cache,
                                    torch.from_numpy(toks[:, i]), pos)
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL
    assert sorted(cache) == sorted(jcache)  # JAX returns its keys sorted
    for name in cache:
        assert _rel(cache[name].numpy(), jcache[name]) < MIX_TOL, name


@pytest.mark.parametrize("window", [0, 4])
def test_decode_matches_forward(window):
    """Token by token from a zero cache, decode reproduces forward's
    logits: the KV cache and the mamba states carry across steps."""
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
    assert float(cache["ssm"].abs().max()) > 0


def test_params_from_numpy_carries_hybrid_names():
    cfg = _cfg()
    params, model = _pair(cfg)
    blocks = params["blocks"]
    names = {"ln_pa", "ln_pm", "m_in", "m_conv", "m_xbc", "m_alog", "m_dtb",
             "m_d", "m_out", "w_gate", "w_up", "w_down"}
    assert names <= set(blocks)
    for i, blk in enumerate(model.blocks):
        for name in names:
            assert torch.equal(getattr(blk, name),
                               torch.from_numpy(np.array(blocks[name][i])))
    tree = jax.tree.map(np.asarray, params)
    del tree["blocks"]["m_dtb"]
    with pytest.raises(ValueError, match="parameter names differ"):
        params_from_numpy(tree, cfg, device="cpu")


def test_init_params_hybrid_scales():
    """Each new weight is drawn with the JAX ``ParamFactory``'s std,
    1/sqrt of its stacked shape's second-to-last dim; the rest are ones
    and zeros as ``init_mamba`` and ``init_blocks`` make them."""
    cfg = _cfg()
    model = tm.init_params(cfg, seed=4, device="cpu")
    blk = model.blocks[0]
    d, di, n = cfg.d_model, TM.d_inner(cfg), cfg.ssm_state
    shapes = {"m_in": (d, 2 * di), "m_conv": (TM.CONV_K, di),
              "m_xbc": (di, 2 * n + 1), "m_out": (di, d), "m_alog": (di,),
              "m_dtb": (di,), "m_d": (di,), "ln_pa": (d,), "ln_pm": (d,)}
    for name, shape in shapes.items():
        assert tuple(getattr(blk, name).shape) == shape, name
    for t, want in ((blk.m_in, d ** -0.5), (blk.m_conv, 0.5),
                    (blk.m_xbc, di ** -0.5), (blk.m_out, di ** -0.5)):
        assert abs(float(t.std()) / want - 1) < 0.1
    for name, value in (("m_alog", 0.0), ("m_dtb", 0.0), ("m_d", 1.0),
                        ("ln_pa", 1.0), ("ln_pm", 1.0)):
        assert torch.equal(getattr(blk, name),
                           torch.full(shapes[name], value)), name
    again = tm.init_params(cfg, seed=4, device="cpu")
    assert torch.equal(again.blocks[1].m_xbc, model.blocks[1].m_xbc)


def test_cache_layout():
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16")
    cache = init_cache(cfg, 3, 20, device="cpu")
    L, di = cfg.n_layers, TM.d_inner(cfg)
    assert list(cache) == ["k", "v", "conv", "ssm"]
    assert cache["k"].shape == (L, 3, 20, cfg.n_kv_heads, cfg.head_dim)
    assert cache["conv"].shape == (L, 3, TM.CONV_K - 1, di)
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["ssm"].shape == (L, 3, di, cfg.ssm_state)
    assert cache["ssm"].dtype == torch.float32


def test_engine_tokens_identical_to_jax():
    """Same weights, same requests: the same greedy tokens.  Five requests
    on two slots exercise chunking, left-padding and ragged max_new."""
    cfg = _cfg()
    params, model = _pair(cfg)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, size=3 + i % 4)
               for i in range(5)]
    max_new = [4, 6, 5, 4, 3]
    want = JaxServingEngine(cfg, params, slots=2, max_seq=16).run(
        [JaxRequest(i, p, m) for i, (p, m) in enumerate(zip(prompts,
                                                             max_new))])
    got = ServingEngine(cfg, model, slots=2, max_seq=16, device="cpu").run(
        [Request(i, p, m) for i, (p, m) in enumerate(zip(prompts, max_new))])
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert len(g.out) == g.max_new
        np.testing.assert_array_equal(g.out, np.asarray(w.out))


def test_launcher_serves_hymba_on_cpu():
    rep = tlaunch.main(["--arch", ARCH, "--device", "cpu", "--requests",
                        "2", "--max-new", "3", "--max-seq", "16"])
    assert rep["arch"] == "hymba-1.5b-smoke"
    assert rep["requests"] == 2 and rep["tokens"] == 6

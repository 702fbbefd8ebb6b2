"""The port's encdec (whisper-tiny) and vlm (internvl2-2b) families against
the JAX package's, in float32 on the CPU, and the config registry's
init_cache layouts for every architecture.

Both configs are ``reduced()`` with two KV heads, so that GQA grouping is
exercised.  Weights come from the JAX ``init_params`` and reach the port
through ``params_from_numpy``; the stub frontends' frame and patch
embeddings are drawn from a NumPy seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import attention as JA
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import model as JMOD
from repro.serve.serve_step import Request as JaxRequest
from repro.serve.serve_step import ServingEngine as JaxServingEngine
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as tm
from repro_torch.models.cache import init_cache
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.serve_step import Request, ServingEngine

# the repo's decode/forward tolerance (tests/test_decode_consistency.py)
TOL = 2e-3
# a layer alone in float32: max abs error over the largest |output|
LAYER_TOL = 1e-6
ARCHS = ["whisper-tiny", "internvl2-2b"]


def _cfg(arch, **kw):
    return dataclasses.replace(jax_get_config(arch).reduced(), n_kv_heads=2,
                               **kw)


def _pair(cfg):
    params, _ = jax_init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return params, model


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / np.max(np.abs(want)))


def _batches(cfg, B, S, seed=0, prefix=None):
    """The same batch for both packages: tokens, and the stub frontend's
    frames (encdec) or patches (vlm; ``prefix`` of them, default
    ``cfg.enc_seq``) drawn N(0, 1) from ``seed``."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, (B, S))
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    key = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
    if key:
        n = cfg.enc_seq if prefix is None else prefix
        emb = rs.standard_normal((B, n, cfg.d_model)).astype(np.float32)
        jb[key], tb[key] = jnp.asarray(emb), torch.from_numpy(emb)
    return jb, tb


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jax_list_archs())
def test_init_cache_matches_jax(arch):
    """Names (in the JAX package's order), shapes and dtypes of every
    architecture's decode state, in bfloat16 as the configs are."""
    cfg = dataclasses.replace(jax_get_config(arch).reduced(),
                              dtype="bfloat16")
    want, _ = jax_init_cache(cfg, 3, 20, abstract=True)
    got = init_cache(cfg, 3, 20, device="cpu")
    assert list(got) == list(want)
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name
        assert not bool(t.float().abs().max())


def test_fp8_cross_kv_cache_dtype():
    cfg = _cfg("whisper-tiny", kv_cache_dtype="float8_e4m3fn")
    cache = init_cache(cfg, 1, 8, device="cpu")
    shape = (cfg.n_layers, 1, cfg.enc_seq, 2, cfg.head_dim)
    for name in ("xk", "xv"):
        assert cache[name].dtype == torch.float8_e4m3fn
        assert tuple(cache[name].shape) == shape


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """Population variance, float32 math, cast back: float32 within
    ``LAYER_TOL`` of the largest output, bfloat16 within one bf16 ulp."""
    rs = np.random.RandomState(0)
    x = (rs.standard_normal((3, 7, 96)) * 3 + 1).astype(np.float32)
    scale, bias = (rs.standard_normal(96).astype(np.float32)
                   for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JL.layernorm(*(jnp.asarray(t, jdt) for t in (x, scale, bias)))
    got = TL.layernorm(*(torch.from_numpy(t).to(tdt)
                         for t in (x, scale, bias)))
    assert got.dtype == tdt
    tol = LAYER_TOL if dtype == "float32" else 2 ** -7
    assert _rel(got.float().numpy(), want) < tol


def test_gelu_mlp_matches_jax():
    """With non-zero biases; the tanh approximation (``jax.nn.gelu``'s
    default), which the exact erf form misses by more than the limit."""
    cfg = _cfg("whisper-tiny")
    params, _ = jax_init_params(cfg, jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    w_in, w_out = (np.array(params["blocks"][k][0]) for k in ("w_in",
                                                              "w_out"))
    b_in = rs.standard_normal(cfg.d_ff).astype(np.float32)
    b_out = rs.standard_normal(cfg.d_model).astype(np.float32)
    x = rs.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    args = (x, w_in, b_in, w_out, b_out)
    want = JL.gelu_mlp(*(jnp.asarray(t) for t in args))
    got = TL.gelu_mlp(*(torch.from_numpy(t) for t in args))
    assert _rel(got.numpy(), want) < LAYER_TOL
    tx, twi, tbi, two, tbo = (torch.from_numpy(t) for t in args)
    erf = F.gelu(tx @ twi + tbi) @ two + tbo
    assert _rel(erf.numpy(), want) > 10 * LAYER_TOL


def test_sinusoid_matches_jax():
    """whisper's 1500 encoder positions at d = 384: within two float32
    ulps of the largest angle (1500 rad), where one ulp of a frequency
    (the two packages' ``exp`` may round apart) moves sin and cos."""
    pos = np.arange(1500)
    want = JMOD._sinusoid(jnp.asarray(pos), 384)
    got = tm._sinusoid(torch.from_numpy(pos), 384)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1500, 384)
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < 2 * (
        np.spacing(np.float32(1500)))
    # half - 1 in the frequency's denominator, not half
    assert float(got[1, 191]) == pytest.approx(np.sin(1e-4), rel=1e-5)


# ---------------------------------------------------------------------------
# the encoder and the cross attention
# ---------------------------------------------------------------------------

def test_encode_matches_jax():
    cfg = _cfg("whisper-tiny")
    params, model = _pair(cfg)
    jb, tb = _batches(cfg, 2, 4)
    want = JMOD.encode(params, cfg, jb["frames"])
    got = tm.encode(model, cfg, tb["frames"])
    assert tuple(got.shape) == (2, cfg.enc_seq, cfg.d_model)
    assert _rel(got.numpy(), want) < 1e-4


def test_encoder_never_takes_the_kernel(monkeypatch):
    """The encoder's self attention is bidirectional: with
    ``attn_impl="pallas"`` it still takes the einsum path, and only the
    decoder's causal self attention reaches K1 (one call a layer)."""
    cfg = _cfg("whisper-tiny", attn_impl="pallas")
    _, model = _pair(cfg)
    calls = []
    orig = TA.kops.flash_attention

    def counted(q, k, v, causal=True, window=0):
        calls.append((tuple(q.shape), causal, window))
        return orig(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(TA.kops, "flash_attention", counted)
    tm.forward(model, cfg, _batches(cfg, 2, 6)[1])
    assert calls == [((2, 6, cfg.n_heads, cfg.head_dim), True, 0)] * 2


@pytest.mark.parametrize("S", [1, 7])
def test_cross_attention_matches_jax(S):
    """``encoder_kv`` of a seeded encoder output and ``cross_attention``
    of a seeded decoder state, layer 0's weights."""
    cfg = _cfg("whisper-tiny")
    params, model = _pair(cfg)
    lp = {k: v[0] for k, v in params["blocks"].items()}
    rs = np.random.RandomState(S)
    x = (rs.standard_normal((2, S, cfg.d_model)) * 0.3).astype(np.float32)
    enc = (rs.standard_normal((2, cfg.enc_seq, cfg.d_model))
           * 0.3).astype(np.float32)
    jk, jv = JA.encoder_kv(lp, jnp.asarray(enc))
    tk, tv = TA.encoder_kv(model.blocks[0], torch.from_numpy(enc))
    assert tuple(tk.shape) == (2, cfg.enc_seq, 2, cfg.head_dim)
    assert _rel(tk.numpy(), jk) < LAYER_TOL and _rel(tv.numpy(), jv) < (
        LAYER_TOL)
    want = JA.cross_attention(lp, jnp.asarray(x), jk, jv, cfg)
    got = TA.cross_attention(model.blocks[0], torch.from_numpy(x), tk, tv,
                             cfg)
    assert _rel(got.numpy(), want) < 1e-5


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("window", [0, 4])
def test_forward_matches_jax(arch, impl, window):
    """``attn_impl="pallas"``: the JAX side runs its Pallas kernel in
    interpret mode, the port the kernels' plain versions (a CPU tensor).
    A window of 4 bites on internvl2's 16 patches + 12 tokens; whisper's
    decoder attends with no window whatever it is given."""
    cfg = _cfg(arch, attn_impl=impl)
    params, model = _pair(cfg)
    jb, tb = _batches(cfg, 2, 12)
    want, _ = jax_forward(params, cfg, jb, window=window)
    got, aux = tm.forward(model, cfg, tb, window=window)
    assert got.shape == want.shape == (2, 12, cfg.vocab_size)
    assert float(aux) == 0.0
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < TOL


def _seeded_cache(cfg, B, S, seed=6):
    """A decode state of ``init_cache``'s layout with every entry drawn
    from ``seed`` (whisper's ``xk``/``xv`` included): (JAX's, the
    port's)."""
    jcache, _ = jax_init_cache(cfg, B, S)
    rs = np.random.RandomState(seed)
    arrs = {k: (rs.standard_normal(v.shape) * 0.5).astype(np.float32)
            for k, v in jcache.items()}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrs.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """From a seeded cache, token by token: the logits and every cache
    entry (whisper's ``xk``/``xv`` read and left as they were)."""
    cfg = _cfg(arch)
    params, model = _pair(cfg)
    B, S, start = 2, 6, 5
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S))
    jcache, cache = _seeded_cache(cfg, B, start + S + 1)
    before = {k: v.clone() for k, v in cache.items()}
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
        assert _rel(cache[name].numpy(), jcache[name]) < 1e-5, name
    for name in ("xk", "xv"):
        if name in cache:
            assert torch.equal(cache[name], before[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Token by token from a zero KV cache, decode reproduces forward's
    logits: for whisper with ``xk``/``xv`` filled from the encoder of the
    same frames; for internvl2 with no patches (decode sees text only)."""
    cfg = _cfg(arch)
    _, model = _pair(cfg)
    B, S = 2, 12
    _, tb = _batches(cfg, B, S, seed=2,
                     prefix=0 if cfg.family == "vlm" else None)
    full, _ = tm.forward(model, cfg, tb)
    cache = init_cache(cfg, B, S + 4, device="cpu")
    if cfg.family == "encdec":
        enc = tm.encode(model, cfg, tb["frames"])
        for i, blk in enumerate(model.blocks):
            cache["xk"][i], cache["xv"][i] = TA.encoder_kv(blk, enc)
    toks = tb["tokens"]
    dec = []
    for i in range(S):
        logits, cache = tm.decode_step(model, cfg, cache, toks[:, i], i)
        dec.append(logits)
    assert float((torch.stack(dec, 1) - full).abs().max()) < TOL


def test_vlm_logits_are_the_text_s():
    """The patches lead the text: the logits cover the text only, and
    they see the patches (other patches give other logits)."""
    cfg = _cfg("internvl2-2b")
    _, model = _pair(cfg)
    _, tb = _batches(cfg, 2, 5, seed=3)
    a, _ = tm.forward(model, cfg, tb)
    tb["patches"] = tb["patches"] + 1.0
    b, _ = tm.forward(model, cfg, tb)
    assert tuple(a.shape) == (2, 5, cfg.vocab_size)
    assert float((a - b).abs().max()) > 1e-2


def test_params_from_numpy_carries_the_encoder():
    cfg = _cfg("whisper-tiny")
    params, model = _pair(cfg)
    assert len(model.enc) == cfg.enc_layers
    for i, blk in enumerate(model.enc):
        for name, arr in params["enc"].items():
            assert torch.equal(getattr(blk, name),
                               torch.from_numpy(np.array(arr[i]))), name
    for name in ("enc_norm", "enc_norm_b", "final_norm_b"):
        assert torch.equal(getattr(model, name),
                           torch.from_numpy(np.array(params[name])))
    for i, blk in enumerate(model.blocks):
        for name in ("xwq", "xwk", "xwv", "xwo", "ln_x", "lnb_x", "b_in"):
            assert torch.equal(getattr(blk, name), torch.from_numpy(
                np.array(params["blocks"][name][i]))), name
    for cut in (("enc", "lnb1"), (None, "enc_norm_b"), ("blocks", "xwo")):
        tree = jax.tree.map(np.asarray, params)
        del (tree[cut[0]] if cut[0] else tree)[cut[1]]
        with pytest.raises(ValueError, match="parameter names differ"):
            params_from_numpy(tree, cfg, device="cpu")
    tree = jax.tree.map(np.asarray, params)
    del tree["enc"]
    with pytest.raises(ValueError, match="parameter names differ"):
        params_from_numpy(tree, cfg, device="cpu")


def test_init_params_encdec_scales():
    """Each new weight is drawn with the JAX ``ParamFactory``'s std,
    1/sqrt of its stacked shape's second-to-last dim; the LayerNorm
    scales start at one, its biases and the MLP's at zero."""
    cfg = _cfg("whisper-tiny")
    model = tm.init_params(cfg, seed=4, device="cpu")
    d, f, H, Dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    blk, enc = model.blocks[0], model.enc[1]
    assert tuple(blk.xwq.shape) == (d, H, Dh)
    assert tuple(blk.xwk.shape) == (d, 2, Dh)
    assert tuple(enc.w_in.shape) == (d, f)
    for t, want in ((blk.xwq, H ** -0.5), (blk.xwk, 2 ** -0.5),
                    (blk.xwo, Dh ** -0.5), (blk.w_in, d ** -0.5),
                    (blk.w_out, f ** -0.5), (enc.wq, H ** -0.5),
                    (enc.w_in, d ** -0.5), (enc.w_out, f ** -0.5)):
        assert abs(float(t.std()) / want - 1) < 0.1
    for mod, names, value in (
            (blk, ("ln1", "ln2", "ln_x"), 1.0),
            (blk, ("lnb1", "lnb2", "lnb_x", "b_in", "b_out"), 0.0),
            (enc, ("ln1", "ln2"), 1.0),
            (enc, ("lnb1", "lnb2", "b_in", "b_out"), 0.0),
            (model, ("enc_norm", "final_norm"), 1.0),
            (model, ("enc_norm_b", "final_norm_b"), 0.0)):
        for name in names:
            t = getattr(mod, name)
            assert torch.equal(t, torch.full(t.shape, value)), name
    again = tm.init_params(cfg, seed=4, device="cpu")
    assert torch.equal(again.enc[1].w_out, enc.w_out)


def test_vlm_takes_the_dense_block():
    cfg = _cfg("internvl2-2b")
    model = tm.init_params(cfg, seed=0, device="cpu")
    assert type(model.blocks[0]).__name__ == "DenseBlock"
    assert not hasattr(model, "enc")
    assert tuple(model.unembed.shape) == (cfg.d_model, cfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_identical_to_jax(arch):
    """Same weights, same requests: the same greedy tokens.  Neither
    engine fills whisper's ``xk``/``xv`` (the decoder cross-attends the
    zero cache) and a served vlm sees text only, in both packages."""
    cfg = _cfg(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_cpu(arch):
    rep = tlaunch.main(["--arch", arch, "--device", "cpu", "--requests",
                        "2", "--max-new", "3", "--max-seq", "16"])
    assert rep["arch"] == f"{arch}-smoke"
    assert rep["requests"] == 2 and rep["tokens"] == 6


# ---------------------------------------------------------------------------
# the smoke's model checks, at a small size with the kernels' plain versions
# ---------------------------------------------------------------------------

def _smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["hymba-1.5b", "internvl2-2b",
                                  "whisper-tiny"])
def test_smoke_model_checks_on_cpu(arch):
    """``chip_smoke``'s per-layer checks of the new families on a CPU
    model, where the kernel path takes the plain versions: each layer on
    ``forward``'s own input (internvl2's patches ahead of the text,
    whisper's cross K/V from the encoder) passes the K1 check and the
    layer gate, the depth agreement is whole, the K3 counts are the ones
    the smoke gates on the card, and hymba's decode check passes."""
    smoke = _smoke()
    cfg = _cfg(arch, n_layers=2)
    params, model = _pair(cfg)
    batch = smoke.prefill_batch(cfg, 12, 0, device="cpu")
    assert batch["tokens"].shape == (4, 12)
    res = smoke._layerwise(model, cfg, batch, smoke._attention_check)
    assert len(res["kernel"]) == cfg.n_layers
    assert all(g["ok"] for g in res["kernel"]), res["kernel"]
    assert max(res["block_rel_diff"]) < 2e-4
    for depth in (1, 2):
        agree = smoke._depth_agreement(model, cfg, batch, depth)
        assert agree["top1"] == 1.0 and agree["max_abs_logit_diff"] < TOL
    want = {"hymba-1.5b": 4 * 2 + 1, "internvl2-2b": 2 * 2 + 1,
            "whisper-tiny": 0}[arch]
    assert smoke.norms_per_forward(cfg) == want
    full = {"hymba-1.5b": 129, "internvl2-2b": 49, "whisper-tiny": 0}[arch]
    assert smoke.norms_per_forward(jax_get_config(arch)) == full
    if cfg.family == "hybrid":
        short = {"tokens": batch["tokens"][:, :8]}
        dec = smoke._decode_check(model, cfg, short)
        assert max(dec["pallas_max_abs_diff"], dec["xla_max_abs_diff"]) < TOL


@pytest.mark.parametrize("arch", jax_list_archs())
def test_kernel_path_inputs_meet_the_kernels_layout_rules(arch, monkeypatch):
    """Every K1 and K3 call of a bf16 kernel-path ``forward`` on the CPU
    passes the layout checks the card's wrappers make before launching
    (K1: TMA's head-dim, alignment and stride rules on q, k, v and the
    output; K3: rows that collapse to one stride), so the card takes the
    same inputs: the CPU's plain versions would take anything."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms
    cfg = dataclasses.replace(jax_get_config(arch).reduced(max_d_model=128),
                              dtype="bfloat16", attn_impl="pallas")
    calls = {"flash_attention": 0, "rmsnorm": 0}
    flash, norm = ops.flash_attention, ops.rmsnorm

    def checked_flash(q, k, v, causal=True, window=0):
        out = torch.empty(q.shape, dtype=q.dtype)
        for t in (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  out.transpose(1, 2)):
            assert fa.tma_layout_error(t.shape, t.stride(), t.element_size(),
                                       t.data_ptr()) is None
        calls["flash_attention"] += 1
        return flash(q, k, v, causal, window)

    def checked_norm(x, scale, eps=1e-5):
        assert x.stride(-1) == 1
        rms._rows(x)
        calls["rmsnorm"] += 1
        return norm(x, scale, eps)
    monkeypatch.setattr(ops, "flash_attention", checked_flash)
    monkeypatch.setattr(ops, "rmsnorm", checked_norm)
    model = tm.init_params(cfg, seed=0, device="cpu")
    tb = _batches(cfg, 2, 9)[1]
    tb = {k: v if k == "tokens" else v.bfloat16() for k, v in tb.items()}
    logits, _ = tm.forward(model, cfg, tb)
    assert logits.shape == (2, 9, cfg.vocab_size)
    attn_layers = 0 if cfg.family == "ssm" else cfg.n_layers
    assert calls["flash_attention"] == attn_layers
    assert calls["rmsnorm"] > 0 or cfg.family == "encdec"

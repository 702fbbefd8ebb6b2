"""The port's rwkv6 against the JAX package's, on the CPU.

Kernel function: on a CPU tensor the port's ``ops.rwkv6_scan`` takes the
plain version (``repro_torch.kernels.ref``); the JAX side runs its Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` does.  The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py``.

Model: reduced rwkv6-7b in float32 (2 layers, d_model 512, 4 heads of 128).
``init_rwkv`` starts ``mu``, ``w0``, ``u`` and ``mu_c`` at zero, and with
``mu = 0`` the token shift has no effect, with ``u = 0`` the bonus has none.
So the weights here are the JAX ``init_params`` with those four overwritten
from a NumPy seed, and ``test_perturbed_weights_see_faults`` shows that
they see a dropped token shift, bonus or shift cache where the init does
not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv_kernel
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.serve.serve_step import Request as JaxRequest
from repro.serve.serve_step import ServingEngine as JaxServingEngine
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as trwkv_kernel
from repro_torch.models import model as tm
from repro_torch.models import rwkv as trwkv
from repro_torch.models.cache import init_cache
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.serve_step import Request, ServingEngine

# the JAX package's kernel tolerances (tests/test_kernels.py) and its
# decode/forward tolerance (tests/test_decode_consistency.py)
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
STATE_TOL = 5e-2
MODEL_TOL = 2e-3
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# kernel function
# ---------------------------------------------------------------------------

def _scan_inputs(B, H, S, D, seed):
    """Kernel-layout float32 r, k, v, w (B,H,S,D), u (H,D), s0 (B,H,D,D)
    with the statistics of tests/test_kernels.py::test_rwkv6_sweep."""
    rs = np.random.RandomState(seed)
    r, k, v = (0.5 * rs.standard_normal((B, H, S, D)) for _ in range(3))
    w = 1 / (1 + np.exp(1 - rs.standard_normal((B, H, S, D)))) * 0.98 + 0.01
    u = 0.3 * rs.standard_normal((H, D))
    s0 = 0.2 * rs.standard_normal((B, H, D, D))
    return [a.astype(np.float32) for a in (r, k, v, w, u, s0)]


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(TORCH_DT[dtype])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _port_scan(r, k, v, w, u, s0):
    """The port's ops.rwkv6_scan on kernel-layout tensors, through the
    model layout it takes; returns the output in kernel layout."""
    out, s = tops.rwkv6_scan(*(t.transpose(1, 2) for t in (r, k, v, w)),
                             u, s0)
    return out.transpose(1, 2), s


def _maxerr(a, b):
    return float(np.max(np.abs(_f32(a) - _f32(b))))


@pytest.mark.parametrize("B,H,S,D,chunk", [
    (1, 2, 64, 16, 16), (2, 2, 128, 32, 32), (1, 1, 96, 64, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_scan_sweep(B, H, S, D, chunk, dtype):
    """The sweep of tests/test_kernels.py, with w in the same dtype as r."""
    arrs = _scan_inputs(B, H, S, D, 0)
    jx = [_jax(a, dtype) for a in arrs[:5]] + [jnp.asarray(arrs[5])]
    tx = [_torch(a, dtype) for a in arrs[:5]] + [torch.from_numpy(arrs[5])]
    out, s = _port_scan(*tx)
    assert out.dtype == TORCH_DT[dtype] and s.dtype == torch.float32
    jout, js = jax_rwkv_kernel(*jx, chunk=chunk)
    assert _maxerr(out, jout) < TOL[dtype] and _maxerr(s, js) < STATE_TOL
    rout, rs_ = jref.rwkv6_scan_ref(*jx)
    assert _maxerr(out, rout) < TOL[dtype] and _maxerr(s, rs_) < STATE_TOL
    # the plain version in kernel layout is what ops dispatched to
    kout, ks = tref.rwkv6_scan_ref(*tx)
    assert torch.equal(kout, out) and torch.equal(ks, s)


def test_rwkv6_scan_state_chaining():
    """Scanning two halves with the carried state == one full scan."""
    r, k, v, w, u, _ = (torch.from_numpy(a)
                        for a in _scan_inputs(1, 2, 64, 16, 3))
    s0 = torch.zeros(1, 2, 16, 16)
    full, sT = _port_scan(r, k, v, w, u, s0)
    h = 32
    o1, s1 = _port_scan(r[:, :, :h], k[:, :, :h], v[:, :, :h], w[:, :, :h],
                        u, s0)
    o2, s2 = _port_scan(r[:, :, h:], k[:, :, h:], v[:, :, h:], w[:, :, h:],
                        u, s1)
    assert float((torch.cat([o1, o2], 2) - full).abs().max()) < 1e-4
    assert float((s2 - sT).abs().max()) < 1e-4


def test_rwkv6_scan_ragged_matches_jax_wrapper():
    """S=45 is no chunk multiple: the JAX wrapper pads to 64 with w = 1
    (decay-free no-op steps), the port pads nothing; the two agree."""
    arrs = _scan_inputs(2, 2, 45, 32, 4)
    jx = [jnp.asarray(a) for a in arrs]
    tx = [torch.from_numpy(a) for a in arrs]
    out, s = tops.rwkv6_scan(*(t.transpose(1, 2) for t in tx[:4]), *tx[4:])
    jout, js = jops.rwkv6_scan(*(jnp.swapaxes(t, 1, 2) for t in jx[:4]),
                               *jx[4:], impl="pallas")
    assert out.shape == (2, 45, 2, 32)
    assert _maxerr(out, jout) < 2e-4 and _maxerr(s, js) < 2e-4


def test_rwkv6_scan_mixed_dtypes_match_jax():
    """The bf16 model's call: bf16 r, k, v and u, float32 w and state.
    Both sides do the math in float32 from the same inputs, so they agree
    well inside the bf16 tolerance; w is not rounded to bf16."""
    r, k, v, w, u, s0 = _scan_inputs(2, 2, 96, 64, 5)
    jx = [_jax(a, "bfloat16") for a in (r, k, v)]
    tx = [_torch(a, "bfloat16") for a in (r, k, v)]
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    out, s = _port_scan(*tx, tw, _torch(u, "bfloat16"), torch.from_numpy(s0))
    jout, js = jax_rwkv_kernel(*jx, jw, _jax(u, "bfloat16"),
                               jnp.asarray(s0), chunk=32)
    assert out.dtype == torch.bfloat16
    assert _maxerr(out, jout) < TOL["bfloat16"]
    assert _maxerr(s, js) < 1e-4
    # w rounded to bf16 gives another state: the float32 w is what counts
    _, s_bf16_w = _port_scan(*tx, tw.to(torch.bfloat16).float(),
                             _torch(u, "bfloat16"), torch.from_numpy(s0))
    assert float((s_bf16_w - s).abs().max()) > 100 * _maxerr(s, js)


def test_kernel_wrapper_rejects_cpu_tensors():
    r, k, v, w, u, s0 = (torch.from_numpy(a)
                         for a in _scan_inputs(1, 2, 8, 16, 0))
    launches = trwkv_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors only"):
        trwkv_kernel.rwkv6_scan(r, k, v, w, u, s0)
    assert trwkv_kernel.LAUNCHES == launches


@pytest.mark.parametrize("change,match", [
    ({"w": torch.bfloat16}, "w must be"),             # bf16 w with f32 r
    ({"k": torch.bfloat16}, "all float32 or all bfloat16"),
    ({"r": torch.float16, "k": torch.float16, "v": torch.float16},
     "all float32 or all bfloat16"),
    ({"u": torch.float16}, "u must be"),
    ({"s0": torch.bfloat16}, "state must be float32"),
])
def test_kernel_wrapper_rejects_dtype_mixes(change, match):
    names = ("r", "k", "v", "w", "u", "s0")
    ts = {n: torch.from_numpy(a)
          for n, a in zip(names, _scan_inputs(1, 2, 8, 16, 0))}
    ts.update({n: ts[n].to(dt) for n, dt in change.items()})
    with pytest.raises(ValueError, match=match):
        trwkv_kernel.rwkv6_scan(*(ts[n] for n in names))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _cfg(**kw):
    return dataclasses.replace(jax_get_config("rwkv6-7b").reduced(), **kw)


def _perturb(tree, seed=0):
    """Non-zero token-shift anchors, bonus and decay base (in place)."""
    rs = np.random.RandomState(seed)
    b = tree["blocks"]
    b["mu"] = rs.uniform(0, 1, b["mu"].shape).astype(np.float32)
    b["mu_c"] = rs.uniform(0, 1, b["mu_c"].shape).astype(np.float32)
    b["u"] = rs.normal(0, 0.5, b["u"].shape).astype(np.float32)
    b["w0"] = rs.normal(-1, 0.5, b["w0"].shape).astype(np.float32)
    return tree


def _trees(perturbed: bool):
    params, _ = jax_init_params(_cfg(), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return _perturb(tree) if perturbed else tree


@pytest.fixture(scope="module")
def weights():
    """{"init" | "perturbed": (numpy tree, JAX params)}."""
    out = {}
    for name in ("init", "perturbed"):
        tree = _trees(name == "perturbed")
        out[name] = (tree, jax.tree.map(jnp.asarray, tree))
    return out


def _port(tree, cfg):
    return params_from_numpy(tree, cfg, device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))


def _jax_decode(cfg):
    return jax.jit(lambda p, c, t, pos: jax_decode_step(p, cfg, c, t, pos))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_matches_jax(weights, impl):
    cfg = _cfg(attn_impl=impl)
    tree, params = weights["perturbed"]
    toks = _tokens(cfg, 2, 40)
    want, _ = jax_forward(params, cfg, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(_port(tree, cfg), cfg,
                          {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape and float(aux) == 0.0
    assert _maxerr(got, want) < MODEL_TOL


def test_decode_step_matches_jax(weights):
    cfg = _cfg()
    tree, params = weights["perturbed"]
    model = _port(tree, cfg)
    B, S = 2, 10
    toks = _tokens(cfg, B, S, seed=1)
    step = _jax_decode(cfg)
    jcache, _ = jax_init_cache(cfg, B, S)
    cache = init_cache(cfg, B, S, device="cpu")
    for i in range(S):
        want, jcache = step(params, jcache, jnp.asarray(toks[:, i]),
                            jnp.int32(i))
        got, cache = tm.decode_step(model, cfg, cache,
                                    torch.from_numpy(toks[:, i]), i)
        assert _maxerr(got, want) < MODEL_TOL
    for name in ("wkv", "shift_t", "shift_c"):
        want = np.asarray(jcache[name])
        err = np.abs(cache[name].numpy() - want).max()
        assert err < 1e-5 * np.abs(want).max(), (name, err)


def test_decode_matches_forward(weights):
    """Token-by-token decode reproduces forward's logits (the recurrent
    state invariant of tests/test_decode_consistency.py), with the kernel
    path (plain version on the CPU) in forward."""
    cfg = _cfg(attn_impl="pallas")
    model = _port(weights["perturbed"][0], cfg)
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=2))
    full, _ = tm.forward(model, cfg, {"tokens": toks})
    cache = init_cache(cfg, B, S, device="cpu")
    dec = []
    for i in range(S):
        logits, cache = tm.decode_step(model, cfg, cache, toks[:, i], i)
        dec.append(logits)
    assert float((torch.stack(dec, 1) - full).abs().max()) < MODEL_TOL


def _faulty_forward_err(weights, which, fault, monkeypatch):
    cfg = _cfg()
    tree, params = weights[which]
    model = _port(tree, cfg)
    toks = _tokens(cfg, 2, 16, seed=3)
    if fault == "shift_cache":  # decode forgets the last token each step
        step = _jax_decode(cfg)
        jcache, _ = jax_init_cache(cfg, 2, 16)
        cache = init_cache(cfg, 2, 16, device="cpu")
        err = 0.0
        for i in range(toks.shape[1]):
            want, jcache = step(params, jcache, jnp.asarray(toks[:, i]),
                                jnp.int32(i))
            got, cache = tm.decode_step(model, cfg, cache,
                                        torch.from_numpy(toks[:, i]), i)
            cache["shift_t"].zero_()
            cache["shift_c"].zero_()
            err = max(err, _maxerr(got, want))
        return err
    if fault == "token_shift":  # every token mixes with itself
        monkeypatch.setattr(trwkv, "_token_shift", lambda x, prev: x)
    elif fault == "bonus":
        for blk in model.blocks:
            blk.u.zero_()
    want, _ = jax_forward(params, cfg, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    return _maxerr(got, want)


@pytest.mark.parametrize("fault", ["token_shift", "bonus", "shift_cache"])
def test_perturbed_weights_see_faults(weights, fault, monkeypatch):
    """A dropped token shift, bonus or shift cache passes against the JAX
    package on the init weights and is caught on the perturbed ones."""
    assert _faulty_forward_err(weights, "init", fault,
                               monkeypatch) < MODEL_TOL
    assert _faulty_forward_err(weights, "perturbed", fault,
                               monkeypatch) > 10 * MODEL_TOL


def test_init_params_follows_init_rwkv(weights):
    cfg = _cfg()
    model = tm.init_params(cfg, seed=3, device="cpu")
    tree = weights["init"][0]
    # zeros and ones where the JAX init has them, the same names and shapes
    assert set(tree) - {"blocks"} == {n for n, _ in
                                      model.named_parameters(recurse=False)}
    for name, want in tree["blocks"].items():
        for i, blk in enumerate(model.blocks):
            got = getattr(blk, name)
            assert tuple(got.shape) == want.shape[1:], name
            for const in (0.0, 1.0):
                if np.all(want[i] == const):
                    assert bool((got == const).all()), (name, const)
    blk = model.blocks[0]
    for t in (blk.mu, blk.w0, blk.u, blk.mu_c):
        assert bool((t == 0).all())
    for t in (blk.ln1, blk.ln2, blk.ln_x, model.final_norm):
        assert bool((t == 1).all())
    for t, want in ((model.embed, 0.02),
                    (model.unembed, cfg.d_model ** -0.5),
                    (blk.wa, cfg.d_model ** -0.5),
                    (blk.wb, trwkv.LORA_R ** -0.5),
                    (blk.wr, cfg.d_model ** -0.5),
                    (blk.wo, cfg.d_model ** -0.5),
                    (blk.wk_c, cfg.d_model ** -0.5),
                    (blk.wv_c, cfg.d_ff ** -0.5)):
        assert abs(float(t.std()) / want - 1) < 0.1


def test_cache_layout():
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16")
    cache = init_cache(cfg, 3, 99, device="cpu")
    L, H, Dh, d = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.d_model
    assert cache["wkv"].shape == (L, 3, H, Dh, Dh)
    assert cache["wkv"].dtype == torch.float32
    for name in ("shift_t", "shift_c"):
        assert cache[name].shape == (L, 3, 1, d)
        assert cache[name].dtype == torch.bfloat16


def test_engine_tokens_identical_to_jax(weights):
    """Same weights, same requests: the same greedy tokens.  Three
    requests on two slots exercise chunking, left-padding and ragged
    max_new."""
    cfg = _cfg()
    tree, params = weights["perturbed"]
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, size=3 + i) for i in range(3)]
    max_new = [4, 3, 5]
    want = JaxServingEngine(cfg, params, slots=2, max_seq=16).run(
        [JaxRequest(i, p, m) for i, (p, m) in enumerate(zip(prompts,
                                                             max_new))])
    got = ServingEngine(cfg, _port(tree, cfg), slots=2, max_seq=16,
                        device="cpu").run(
        [Request(i, p, m) for i, (p, m) in enumerate(zip(prompts, max_new))])
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert len(g.out) == g.max_new
        np.testing.assert_array_equal(g.out, np.asarray(w.out))

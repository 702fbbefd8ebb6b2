"""The port's MoE (``repro_torch.models.moe`` and the moe family's
forward, decode step and serving) against the JAX package's, in float32
on the CPU.

``reduced()`` caps the experts at 4 and top-k at 2, which would send both
MoE configs through the dense form.  qwen3-moe is therefore reduced with
``max_experts=32`` and its top-k set back to 8, so that it takes the
grouped form (``GROUPED_MIN_EXPERTS`` = 32) as at full width; grok-1
keeps ``reduced()``'s 4 experts, top-2, and the dense form.  Both packages
get the same config and the same weights (the JAX ``init_params``, through
``params_from_numpy``).
"""
import contextlib
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
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.models import moe as TM
from repro_torch.models.cache import init_cache
from repro_torch.models.convert import params_from_numpy

# the repo's decode/forward tolerance (tests/test_decode_consistency.py)
TOL = 2e-3
# the JAX package's own bounds between its MoE forms
# (tests/test_moe_variants.py)
OUT_TOL = 2e-4
AUX_TOL = 1e-6
ARCHS = ("qwen3-moe-235b-a22b", "grok-1-314b")
FORMS = ("moe_ffn_dense", "moe_ffn_flat", "moe_ffn_grouped")
AMPLE, TIGHT = 8.0, 0.05


def _cfg(arch, **kw):
    if arch == "qwen3-moe-235b-a22b":
        cfg = dataclasses.replace(
            jax_get_config(arch).reduced(max_d_model=128, max_experts=32),
            top_k=8)
    else:
        cfg = jax_get_config(arch).reduced()
    return dataclasses.replace(cfg, **kw)


def _layer(cfg):
    """Layer 0's MoE weights: the JAX dict and the port's namespace."""
    params, _ = jax_init_params(cfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: np.array(a[0]), params["blocks"])
    return lp, SimpleNamespace(**{k: torch.from_numpy(v)
                                  for k, v in lp.items()})


def _x(cfg, B=2, S=32, seed=1):
    return (np.random.RandomState(seed).standard_normal(
        (B, S, cfg.d_model)) * 0.3).astype(np.float32)


def _pair(cfg):
    params, _ = jax_init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return params, model


def _tokens(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))


def _diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@contextlib.contextmanager
def _routes(monkeypatch):
    """Record the expert choice (top-k indices) of every ``route`` call in
    both packages, in call order.  The JAX calls are recorded under
    ``jax.disable_jit``, where the layer scan runs eagerly."""
    got = {"jax": [], "torch": []}
    for key, mod in (("jax", JM), ("torch", TM)):
        def rec(logits, cfg, _orig=mod.route, _key=key):
            out = _orig(logits, cfg)
            got[_key].append(np.asarray(out[1]))
            return out
        monkeypatch.setattr(mod, "route", rec)
    yield got
    monkeypatch.undo()


def _assert_same_routes(got):
    assert len(got["jax"]) == len(got["torch"]) > 0
    for i, (a, b) in enumerate(zip(got["jax"], got["torch"])):
        flips = int(np.sum(np.any(a != b, axis=-1)))
        assert flips == 0, f"route call {i}: {flips} tokens routed differently"


# ---------------------------------------------------------------------------
# units: capacity, route, the three dispatch forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [0.05, 1.0, 1.25, 8.0])
def test_capacity_matches_jax(arch, factor):
    for base in (_cfg(arch), jax_get_config(arch)):
        cfg = dataclasses.replace(base, capacity_factor=factor)
        for n in (1, 2, 3, 7, 16, 33, 1024, 4096):
            assert TM.capacity(n, cfg) == JM.capacity(n, cfg), (n, cfg.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    cfg = _cfg(arch)
    logits = np.random.RandomState(2).standard_normal(
        (64, cfg.n_experts)).astype(np.float32) * 2.0
    jw, ji, ja = JM.route(jnp.asarray(logits), cfg)
    tw, ti, ta = TM.route(torch.from_numpy(logits), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert _diff(tw.numpy(), jw) < 1e-6
    assert abs(float(ta) - float(ja)) < 1e-6
    # uniform logits: every expert's probability is 1/E, so aux is 1
    zeros = np.zeros((64, cfg.n_experts), np.float32)
    _, _, ja = JM.route(jnp.asarray(zeros), cfg)
    _, _, ta = TM.route(torch.from_numpy(zeros), cfg)
    assert abs(float(ta) - float(ja)) < 1e-6 and abs(float(ta) - 1.0) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("cap", [AMPLE, TIGHT])
def test_ffn_form_matches_jax(arch, form, cap):
    """Each form against the reference's same form.  At the tight
    capacity slots drop, so a dispatch that assigned where the reference
    adds (a dropped slot's zero row over a kept token) would show here."""
    cfg = _cfg(arch, capacity_factor=cap)
    lp, p = _layer(cfg)
    x = _x(cfg)
    want, want_aux = getattr(JM, form)(lp, jnp.asarray(x), cfg)
    got, aux = getattr(TM, form)(p, torch.from_numpy(x), cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _diff(got.numpy(), want) < OUT_TOL
    assert abs(float(aux) - float(want_aux)) < AUX_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_tight_capacity_drops_slots(arch):
    """The tight case above really drops slots in both buffer forms, and
    a dropped slot's zero lands on a place a kept slot holds."""
    cfg = _cfg(arch, capacity_factor=TIGHT)
    _, p = _layer(cfg)
    x = torch.from_numpy(_x(cfg))
    B, S, _ = x.shape
    _, topi, _ = TM.route((x @ p.router).reshape(B * S, -1), cfg)
    for e_idx, C in ((topi.reshape(B, -1), TM.capacity(S, cfg)),
                     (topi.reshape(1, -1), TM.capacity(B * S, cfg))):
        keep, posc = TM._positions(e_idx, cfg.n_experts, C)
        assert 0 < int((~keep).sum()) < keep.numel()
        rows = torch.arange(e_idx.shape[0])[:, None].expand_as(e_idx)
        place = torch.stack([rows, e_idx, posc], -1)
        held = set(map(tuple, place[keep].tolist()))
        assert set(map(tuple, place[~keep].tolist())) <= held


@pytest.mark.parametrize("arch", ARCHS)
def test_port_forms_agree_ample_capacity(arch):
    """The port's mirror of tests/test_moe_variants.py: with ample
    capacity the three forms are the same function."""
    cfg = _cfg(arch, capacity_factor=AMPLE)
    _, p = _layer(cfg)
    x = torch.from_numpy(_x(cfg))
    outs = {f: getattr(TM, f)(p, x, cfg) for f in FORMS}
    o0, a0 = outs["moe_ffn_flat"]
    for f in ("moe_ffn_dense", "moe_ffn_grouped"):
        o, a = outs[f]
        assert float((o - o0).abs().max()) < OUT_TOL, f
        assert abs(float(a - a0)) < AUX_TOL, f
    again, _ = TM.moe_ffn_grouped(p, x, cfg)
    assert torch.equal(again, outs["moe_ffn_grouped"][0])


def test_dispatch_selection_by_granularity():
    assert TM.GROUPED_MIN_EXPERTS == JM.GROUPED_MIN_EXPERTS == 32
    assert get_config("grok-1-314b").n_experts < TM.GROUPED_MIN_EXPERTS
    assert get_config("qwen3-moe-235b-a22b").n_experts >= \
        TM.GROUPED_MIN_EXPERTS
    for arch, form in (("grok-1-314b", "moe_ffn_dense"),
                       ("qwen3-moe-235b-a22b", "moe_ffn_grouped")):
        cfg = _cfg(arch, capacity_factor=1.25)
        _, p = _layer(cfg)
        x = torch.from_numpy(_x(cfg, S=16))
        got, aux = TM.moe_ffn(p, x, cfg)
        want, want_aux = getattr(TM, form)(p, x, cfg)
        assert torch.equal(got, want) and torch.equal(aux, want_aux)


# ---------------------------------------------------------------------------
# the model: forward, decode, convert, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("window", [0, 4])
def test_forward_matches_jax(arch, impl, window, monkeypatch):
    """Default capacity (1.25): the grouped form drops slots at S = 12."""
    cfg = _cfg(arch, attn_impl=impl)
    params, model = _pair(cfg)
    toks = _tokens(cfg, 2, 12)
    with _routes(monkeypatch) as got:
        with jax.disable_jit():
            jax_forward(params, cfg, {"tokens": jnp.asarray(toks)},
                        window=window)
        tm.forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                   window=window)
    _assert_same_routes(got)
    want, want_aux = jax_forward(params, cfg, {"tokens": jnp.asarray(toks)},
                                 window=window)
    logits, aux = tm.forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                             window=window)
    assert logits.shape == want.shape
    assert _diff(logits.numpy(), want) < TOL
    assert float(aux) > 0 and abs(float(aux) - float(want_aux)) < AUX_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch, monkeypatch):
    cfg = _cfg(arch)
    params, model = _pair(cfg)
    B, S = 2, 8
    toks = _tokens(cfg, B, S, seed=1)
    jcache, _ = jax_init_cache(cfg, B, S + 2)
    cache = init_cache(cfg, B, S + 2, device="cpu")
    for i in range(S):
        with _routes(monkeypatch) as got:
            with jax.disable_jit():
                want, _ = jax_decode_step(params, cfg, jcache,
                                          jnp.asarray(toks[:, i]),
                                          jnp.int32(i))
            logits, cache = tm.decode_step(model, cfg, cache,
                                           torch.from_numpy(toks[:, i]), i)
        _assert_same_routes(got)
        want, jcache = jax_decode_step(params, cfg, jcache,
                                       jnp.asarray(toks[:, i]), jnp.int32(i))
        assert _diff(logits.numpy(), want) < TOL, i


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Token by token, decode reproduces forward's logits when forward
    drops nothing (ample capacity; decode's capacity(1) is top_k)."""
    cfg = _cfg(arch, capacity_factor=AMPLE)
    _, model = _pair(cfg)
    B, S = 2, 10
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=2))
    full, _ = tm.forward(model, cfg, {"tokens": toks})
    cache = init_cache(cfg, B, S + 2, device="cpu")
    dec = []
    for i in range(S):
        logits, cache = tm.decode_step(model, cfg, cache, toks[:, i], i)
        dec.append(logits)
    assert float((torch.stack(dec, 1) - full).abs().max()) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_moe_names(arch):
    cfg = _cfg(arch)
    params, model = _pair(cfg)
    blocks = params["blocks"]
    names = {"router", "we_gate", "we_up", "we_down"}
    assert names <= set(blocks)
    for i, blk in enumerate(model.blocks):
        for name in names:
            assert torch.equal(getattr(blk, name),
                               torch.from_numpy(np.array(blocks[name][i])))
    tree = jax.tree.map(np.asarray, params)
    del tree["blocks"]["router"]
    with pytest.raises(ValueError, match="parameter names differ"):
        params_from_numpy(tree, cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_moe_scales(arch):
    """Each MoE weight is drawn with the JAX ``ParamFactory``'s std,
    1/sqrt of its stacked shape's second-to-last dim."""
    cfg = _cfg(arch)
    model = tm.init_params(cfg, seed=4, device="cpu")
    blk = model.blocks[0]
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    assert tuple(blk.router.shape) == (d, E)
    assert tuple(blk.we_gate.shape) == tuple(blk.we_up.shape) == (E, d, f)
    assert tuple(blk.we_down.shape) == (E, f, d)
    for t, want in ((blk.router, d ** -0.5), (blk.we_gate, d ** -0.5),
                    (blk.we_up, d ** -0.5), (blk.we_down, f ** -0.5)):
        assert abs(float(t.std()) / want - 1) < 0.05
    again = tm.init_params(cfg, seed=4, device="cpu")
    assert torch.equal(again.blocks[1].we_down, model.blocks[1].we_down)

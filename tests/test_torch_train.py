"""The port's training slice against the JAX package's, on the CPU:
``repro_torch.data.pipeline`` (bitwise), the optimizer (``adamw``,
``sgdm``, the schedule, the clip) fed the same NumPy grads, the train step
(full batch, microbatched, overfitting one batch, ``remat``),
checkpoints, HadarE's consolidation (``weight_average``,
``consolidate_into``, ``pod_consolidate`` and the fractional optimizer
step of the averaged states), ``launch.train._allocate`` under the same
tracker observations, and ``run_scheduled_training(device="cpu")`` held
to the assertions of ``tests/test_system.py``.  Loss and gradients of
the ten configs are in ``test_torch_train_grads.py``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # offline CI image — vendored fallback
    from _hypothesis_compat import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.core.throughput import ThroughputTracker as JTracker
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.train import consolidate as jcons
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.core.throughput import ThroughputTracker
from repro_torch.data import pipeline as pipe
from repro_torch.launch import train as ttrain
from repro_torch.models.model import batch_tensors, init_params
from repro_torch.train import checkpoint, consolidate, optimizer as topt
from repro_torch.train.train_step import (load_params, make_eval_step,
                                          make_train_step, trainable)

REPO = Path(__file__).resolve().parent.parent
# float32 optimizer arithmetic in another order (sums of squares, cos)
OPT_TOL = 1e-6


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else \
        np.asarray(t, dtype=np.float32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-2b",
                                  "whisper-tiny", "rwkv6-7b"])
@pytest.mark.parametrize("seed", [0, 7])
def test_batch_for_is_bitwise_the_jax_batch(arch, seed):
    """Tokens, labels and the vlm's patches / encdec's frames."""
    cfg = get_config(arch).reduced(max_d_model=128)
    got = pipe.batch_for(cfg, 3, 24, seed=seed)
    want = jpipe.batch_for(jax_get_config(arch).reduced(max_d_model=128), 3,
                           24, seed=seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_batches_from_an_offset_are_bitwise_the_jax_batches():
    """``batches(start=...)``: the driver's data offsets and eval batch."""
    kw = dict(vocab_size=97, seq_len=16, batch_size=2, seed=3, n_batches=0,
              vlm_patches=4, d_model=8)
    ours = pipe.SyntheticLM(pipe.DataConfig(**kw))
    ref = jpipe.SyntheticLM(jpipe.DataConfig(**kw))
    np.testing.assert_array_equal(ours.successor, ref.successor)
    for start in (0, 10_000, 5 * 7 + 2):
        for a, b in zip(ours.batches(start), ref.batches(start)):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
            break
    last = list(pipe.SyntheticLM(pipe.DataConfig(
        **dict(kw, n_batches=3))).batches(1))
    assert len(last) == 2


@settings(max_examples=20, deadline=None)
@given(v=st.integers(8, 512), s=st.integers(2, 64), b=st.integers(1, 8),
       seed=st.integers(0, 10**6))
def test_data_tokens_in_range_and_equal_property(v, s, b, seed):
    dc = dict(vocab_size=v, seq_len=s, batch_size=b, seed=seed)
    batch = next(pipe.SyntheticLM(pipe.DataConfig(**dc)).batches())
    want = next(jpipe.SyntheticLM(jpipe.DataConfig(**dc)).batches())
    assert batch["tokens"].shape == (b, s)
    assert batch["tokens"].min() >= 0 and batch["tokens"].max() < v
    assert batch["labels"].min() >= 0 and batch["labels"].max() < v
    np.testing.assert_array_equal(batch["tokens"], want["tokens"])
    np.testing.assert_array_equal(batch["tokens"][:, 1:],
                                  batch["labels"][:, :-1])


def test_data_has_learnable_structure():
    """bigram successor structure: P(successor | token) >> 1/V."""
    lm = pipe.SyntheticLM(pipe.DataConfig(vocab_size=64, seq_len=512,
                                          batch_size=8, seed=0))
    b = next(lm.batches())
    hits = sum(int(lm.successor[a] == c) for row in b["tokens"]
               for a, c in zip(row[:-1], row[1:]))
    assert hits / (8 * 511) > 0.3   # ~0.65 by construction


# ---------------------------------------------------------------------------
# optimizer: both packages fed the same NumPy grads
# ---------------------------------------------------------------------------

def _leaves(seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return {"a": rs.standard_normal((4, 5)).astype(dtype),
            "b": {"c": (rs.standard_normal((7,)) * 3).astype(dtype)}}


@pytest.mark.parametrize("step", [0, 1, 4, 5, 6, 50, 99, 100, 150, 4.25])
def test_schedule_matches_jax(step):
    oc = dict(lr=1e-2, warmup_steps=5, total_steps=100, min_lr_frac=0.1)
    dt = jnp.float32 if isinstance(step, float) else jnp.int32
    want = float(jopt.schedule(jopt.OptConfig(**oc), jnp.asarray(step, dt)))
    got = float(topt.schedule(topt.OptConfig(**oc), torch.tensor(step)))
    assert abs(got - want) <= OPT_TOL * 1e-2


def test_global_norm_and_clip_match_jax():
    tree = _leaves(0)
    got, n = topt.clip_by_global_norm(
        {"a": torch.tensor(tree["a"]), "b": {"c": torch.tensor(tree["b"]["c"])}},
        1.0)
    want, wn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    assert abs(float(n) - float(wn)) <= OPT_TOL * float(wn)
    assert got["a"].dtype == torch.float32
    np.testing.assert_allclose(_np(got["b"]["c"]), np.asarray(want["b"]["c"]),
                               rtol=1e-6, atol=1e-7)
    assert float(topt.global_norm(got)) <= 1.0 + 1e-5


@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(kind, dtype):
    """Three updates of the same params by the same grads: params (cast
    once to their dtype), moments (float32), step, lr and grad norm."""
    oc = dict(lr=0.05, warmup_steps=2, total_steps=10, kind=kind,
              grad_clip=2.0)
    p_np = _leaves(1)
    jp = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), p_np)
    tp = {"a": torch.tensor(p_np["a"]).to(getattr(torch, dtype)),
          "b": {"c": torch.tensor(p_np["b"]["c"]).to(getattr(torch, dtype))}}
    js = jopt.init_opt_state(jp, jopt.OptConfig(**oc))
    ts = topt.init_opt_state(tp, topt.OptConfig(**oc))
    assert ts.step.dtype == torch.int32 and ts.mu["a"].dtype == torch.float32
    for i in range(3):
        g = _leaves(10 + i)
        jp, js, jm = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, g), js,
                                        jopt.OptConfig(**oc))
        tg = {"a": torch.tensor(g["a"]), "b": {"c": torch.tensor(g["b"]["c"])}}
        tp, ts, tmet = topt.apply_updates(tp, tg, ts, topt.OptConfig(**oc))
        assert int(ts.step) == int(js.step) == i + 1
        for k in ("lr", "grad_norm"):
            assert abs(float(tmet[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k]))
    assert tp["a"].dtype == getattr(torch, dtype)
    # one bf16 rounding apart at most where the f32 updates differ by ulps
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    for ours, ref in ((tp["a"], jp["a"]), (tp["b"]["c"], jp["b"]["c"]),
                      (ts.mu["a"], js.mu["a"]), (ts.nu["b"]["c"], js.nu["b"]["c"])):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(_np(ours), ref, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _setup(arch="llama3.2-1b", lr=3e-3, **cfg_kw):
    cfg = dataclasses.replace(get_config(arch).reduced(), **cfg_kw)
    model = init_params(cfg, seed=0, device="cpu")
    oc = topt.OptConfig(lr=lr, warmup_steps=5, total_steps=100)
    return cfg, model, oc, topt.init_opt_state(trainable(model), oc)


def _batch(cfg, B, S):
    return batch_tensors(pipe.batch_for(cfg, B, S), cfg, "cpu")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_overfit_single_batch(impl):
    cfg, model, oc, st_ = _setup(attn_impl=impl)
    step = make_train_step(cfg, oc)
    b = _batch(cfg, 4, 64)
    first = None
    for _ in range(20):
        model, st_, m = step(model, st_, b)
        first = first or float(m["loss"])
    assert set(m) == {"loss", "ce", "aux", "lr", "grad_norm"}
    assert float(m["loss"]) < first - 1.0, "optimizer failed to learn"
    assert int(st_.step) == 20


def test_microbatch_matches_full_batch():
    """grad-accumulated step ~= full-batch step (same batch, same init)."""
    cfg, model, oc, st_ = _setup()
    other = init_params(cfg, seed=0, device="cpu")
    b = _batch(cfg, 4, 32)
    m1 = make_train_step(cfg, oc)(model, st_, b)[2]
    m2 = make_train_step(cfg, oc, microbatches=2)(other, st_, b)[2]
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-3
    assert float(m2["aux"]) == 0.0 and float(m2["ce"]) == float(m2["loss"])
    diffs = [(a - c).abs().max().item() for a, c in
             zip(model.parameters(), other.parameters())]
    assert max(diffs) < 5e-2


def test_microbatched_step_matches_jax():
    """The accumulated step of both packages on the same weights and
    batch: the mean loss, aux 0, the averaged grads' norm and lr."""
    from repro.models import init_params as jinit
    from repro.train.train_step import make_train_step as jmake
    from repro_torch.models.convert import params_from_numpy
    jcfg = jax_get_config("llama3.2-1b").reduced()
    cfg = get_config("llama3.2-1b").reduced()
    params, _ = jinit(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    nb = pipe.batch_for(cfg, 4, 16)
    oc = dict(lr=3e-3, warmup_steps=5, total_steps=100)
    jo = jopt.OptConfig(**oc)
    _, js, jm = jmake(jcfg, jo, microbatches=2)(
        params, jopt.init_opt_state(params, jo),
        {k: jnp.asarray(v) for k, v in nb.items()})
    to = topt.OptConfig(**oc)
    _, ts, tm = make_train_step(cfg, to, microbatches=2)(
        model, topt.init_opt_state(trainable(model), to),
        batch_tensors(nb, cfg, "cpu"))
    assert int(ts.step) == int(js.step) == 1 and float(tm["aux"]) == 0.0
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-5
    for k in ("grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * float(jm[k])


def test_eval_step_and_remat_keep_the_gradient():
    """``cfg.remat`` checkpoints each block: the grads are those without
    it, and each block's forward runs again in the backward."""
    from repro_torch.models import blocks
    cfg, model, oc, _ = _setup(arch="llama3.2-1b")
    b = _batch(cfg, 2, 16)
    calls = []
    real = blocks.block_fwd

    def counted(c, w):
        f = real(c, w)
        return lambda *a: (calls.append(1), f(*a))[1]
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        from repro_torch.models import model as mm
        loss, _ = mm.loss_fn(model, c, b)
        ps = trainable(model)
        calls.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(blocks, "block_fwd", counted)
            loss, _ = mm.loss_fn(model, c, b)
            grads[remat] = torch.autograd.grad(loss, list(ps.values()))
        assert len(calls) == cfg.n_layers * (2 if remat else 1)
    for a, c in zip(grads[False], grads[True]):
        assert torch.equal(a, c)
    ev = make_eval_step(cfg)(model, b)
    assert abs(float(ev["loss"]) - float(loss)) < 1e-6
    assert not ev["loss"].requires_grad


def test_train_step_updates_the_model_in_place():
    cfg, model, oc, st_ = _setup()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    out, st2, _ = make_train_step(cfg, oc)(model, st_, _batch(cfg, 2, 16))
    assert out is model and int(st2.step) == 1 and int(st_.step) == 0
    assert all(p.data_ptr() == ptrs[n] for n, p in model.named_parameters())
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters())
    load_params(model, before)
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_bf16_with_opt_state(tmp_path):
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(),
                              dtype="bfloat16")
    model = init_params(cfg, seed=1, device="cpu")
    params = {n: p.detach() for n, p in model.named_parameters()}
    oc = topt.OptConfig()
    st_ = topt.init_opt_state(params, oc)
    st_ = st_._replace(step=torch.tensor(4.25),
                       mu={k: v + 0.5 for k, v in st_.mu.items()})
    path = str(tmp_path / "ck" / "ck.npz")
    checkpoint.save(path, {"p": params, "s": st_, "n": [3, (1.5,)]})
    r = checkpoint.restore(path, device="cpu")
    assert isinstance(r["s"], topt.OptState)
    assert float(r["s"].step) == 4.25 and r["s"].step.dtype == torch.float32
    for k, p in params.items():
        assert r["p"][k].dtype == torch.bfloat16 == p.dtype
        assert torch.equal(r["p"][k], p)
        assert torch.equal(r["s"].mu[k], st_.mu[k])
    assert int(r["n"][0]) == 3 and float(r["n"][1][0]) == 1.5
    # the file loads without the port: builtins in the pickle, then npz
    code = ("import io, pickle, sys\nimport numpy as np\n"
            "sys.modules['repro_torch'] = None\nsys.modules['torch'] = None\n"
            "f = open(sys.argv[1], 'rb')\nmeta = pickle.load(f)\n"
            "data = np.load(io.BytesIO(f.read()))\n"
            "print(meta['n'], len(data.files), meta['dtypes'][0])\n")
    res = subprocess.run([sys.executable, "-c", code, path],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    n = len(params) * 3 + 3
    assert res.stdout.split() == [str(n), str(n), "bfloat16"]


def test_restore_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "a.npz")
    checkpoint.save(path, {"a": torch.ones(2)})
    if torch.cuda.is_available():
        assert checkpoint.restore(path)["a"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            checkpoint.restore(path)


# ---------------------------------------------------------------------------
# HadarE consolidation
# ---------------------------------------------------------------------------

def test_weight_average_is_steps_weighted():
    avg = consolidate.weight_average([{"w": torch.ones(3, 3)},
                                      {"w": torch.zeros(3, 3)}], [3.0, 1.0])
    assert torch.allclose(avg["w"], torch.tensor(0.75))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_consolidation_matches_jax(dtype):
    trees = [_leaves(s) for s in range(3)]
    steps = [5, 3, 1]
    jt = [jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), t)
          for t in trees]
    tt = [{"a": torch.tensor(t["a"]).to(getattr(torch, dtype)),
           "b": {"c": torch.tensor(t["b"]["c"]).to(getattr(torch, dtype))}}
          for t in trees]
    pairs = [(consolidate.weight_average(tt, steps),
              jcons.weight_average(jt, steps)),
             (consolidate.consolidate_into(tt[0], tt[1], 0.3),
              jcons.consolidate_into(jt[0], jt[1], 0.3))]
    stacked_t = {"a": torch.stack([t["a"] for t in tt])}
    stacked_j = {"a": jnp.stack([t["a"] for t in jt])}
    pairs.append((consolidate.pod_consolidate(stacked_t, torch.tensor(steps)),
                  jcons.pod_consolidate(stacked_j, jnp.asarray(steps))))
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    for ours, ref in pairs:
        assert ours["a"].dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(ours["a"]), np.asarray(ref["a"],
                                                              np.float32),
                                   rtol=tol, atol=tol)


@settings(max_examples=20, deadline=None)
@given(s1=st.floats(0.1, 100), s2=st.floats(0.1, 100),
       seed=st.integers(0, 1000))
def test_weight_average_convex_property(s1, s2, seed):
    """A convex combination: within the leaf-wise envelope, and exact for
    identical copies (tests/test_hadare.py:96)."""
    rs = np.random.RandomState(seed)
    a, b = (torch.tensor(rs.standard_normal(4).astype(np.float32))
            for _ in range(2))
    avg = consolidate.weight_average([{"w": a}, {"w": b}], [s1, s2])["w"]
    assert bool(((avg >= torch.minimum(a, b) - 1e-6)
                 & (avg <= torch.maximum(a, b) + 1e-6)).all())
    same = consolidate.weight_average([{"w": a}, {"w": a}], [s1, s2])["w"]
    assert torch.allclose(same, a, atol=1e-6)


def test_averaged_opt_state_step_is_fractional_and_the_jax_one():
    """Copies at steps 5 and 3, weights 5 and 3: the step becomes 4.25
    (float32), as ``repro/launch/train.py:197-200`` makes it, and the
    schedule then sees the fractional step."""
    oc = dict(lr=8e-3, warmup_steps=5, total_steps=96)
    p_np = _leaves(2)
    states_t, states_j = [], []
    for step, seed in ((5, 3), (3, 4)):
        g = _leaves(seed)
        states_j.append(jopt.OptState(
            jnp.asarray(step, jnp.int32),
            jax.tree.map(jnp.asarray, g),
            jax.tree.map(lambda x: jnp.asarray(x) ** 2, g)))
        states_t.append(topt.OptState(
            torch.tensor(step, dtype=torch.int32),
            {"a": torch.tensor(g["a"]), "b": {"c": torch.tensor(g["b"]["c"])}},
            {"a": torch.tensor(g["a"]) ** 2,
             "b": {"c": torch.tensor(g["b"]["c"]) ** 2}}))
    steps = [5, 3]
    want = jax.tree.map(lambda *xs: sum(x * (s / sum(steps)) for x, s in
                                        zip(xs, steps)), *states_j)
    got = ttrain.average_opt_states(states_t, steps)
    assert got.step.dtype == torch.float32 and float(got.step) == 4.25
    assert float(want.step) == float(got.step)
    np.testing.assert_allclose(_np(got.mu["a"]), np.asarray(want.mu["a"]),
                               rtol=1e-6, atol=1e-7)
    # one more update from the averaged state in both packages
    grads = _leaves(9)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = {"a": torch.tensor(p_np["a"]), "b": {"c": torch.tensor(p_np["b"]["c"])}}
    _, js, jm = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, grads), want,
                                   jopt.OptConfig(**oc))
    _, ts, tm = topt.apply_updates(
        tp, {"a": torch.tensor(grads["a"]),
             "b": {"c": torch.tensor(grads["b"]["c"])}}, got,
        topt.OptConfig(**oc))
    assert float(ts.step) == float(js.step) == 5.25
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * float(jm["lr"])


# ---------------------------------------------------------------------------
# the scheduled-training driver
# ---------------------------------------------------------------------------

NODES = [("fast", "rtx3090", 1.0), ("mid", "t4", 0.5), ("slow", "t400", 0.2)]


@pytest.mark.parametrize("scheduler", ["hadar", "hadare", "gavel"])
def test_allocate_matches_jax(scheduler):
    """Rounds of ``_allocate`` on stand-in jobs, both packages' trackers
    fed the same observations: the same allocations and round-robin
    state."""
    archs = ["llama3.2-1b", "rwkv6-7b", "qwen3-moe-235b-a22b"]
    nodes_t = ttrain.DEFAULT_NODES
    nodes_j = [jtrain.EmuNode(n.name, n.device, n.speed) for n in nodes_t]
    jobs = [SimpleNamespace(jid=i, arch=a, target_steps=40 + 4 * i,
                            done_steps=0) for i, a in enumerate(archs)]
    tr_t = ThroughputTracker(archs, [n.device for n in nodes_t])
    tr_j = JTracker(archs, [n.device for n in nodes_j])
    rr_t, rr_j = {}, {}
    rs = np.random.RandomState(0)
    for rnd in range(8):
        got = ttrain._allocate(scheduler, jobs, nodes_t, tr_t, rr_t)
        want = jtrain._allocate(scheduler, jobs, nodes_j, tr_j, rr_j)
        assert got == want and rr_t == rr_j, rnd
        for jid, nids in got.items():
            for ni in nids:
                rate = float(rs.uniform(0.1, 50.0))
                tr_t.observe(archs[jid], nodes_t[ni].device, rate)
                tr_j.observe(archs[jid], nodes_j[ni].device, rate)
            jobs[jid].done_steps += 3 + jid
    assert tr_t.coverage() == tr_j.coverage() > 0


def test_hadare_end_to_end_real_training():
    """tests/test_system.py's HadarE run on the port, on the CPU."""
    nodes = [ttrain.EmuNode(*n) for n in NODES]
    init_loss = ttrain.RealJob(0, "llama3.2-1b", 1, seed=0,
                               device="cpu").eval_loss()
    out = ttrain.run_scheduled_training(
        "hadare", archs=["llama3.2-1b"], target_steps=36,
        base_steps_per_round=8, nodes=nodes, verbose=False, seed=0,
        device="cpu")
    assert out["cru"] == 1.0
    assert all(np.isfinite(l) for l in out["eval_losses"].values())
    assert out["eval_losses"]["llama3.2-1b"] < init_loss - 0.15


def test_hadare_uses_fewer_rounds_than_hadar():
    nodes = [ttrain.EmuNode(*n) for n in NODES]
    kw = dict(archs=["llama3.2-1b", "rwkv6-7b"], target_steps=12,
              base_steps_per_round=6, nodes=nodes, verbose=False,
              device="cpu", attn_impl="pallas")
    e = ttrain.run_scheduled_training("hadare", **kw)
    h = ttrain.run_scheduled_training("hadar", **kw)
    assert e["rounds"] <= h["rounds"]
    assert e["cru"] > h["cru"]
    assert e["throughput_coverage"] >= h["throughput_coverage"]


def test_real_job_runs_on_the_card_unless_asked_for_the_cpu():
    job = ttrain.RealJob(0, "rwkv6-7b", 4, device="cpu", attn_impl="pallas")
    assert job.cfg.attn_impl == "pallas" and job.cfg.dtype == "float32"
    assert job.cfg.d_model == 128 and job.cfg.head_dim == 32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.RealJob(0, "llama3.2-1b", 4)


def test_train_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--scheduler",
         "gavel", "--steps", "2", "--rounds", "3", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "'scheduler': 'gavel'" in res.stdout
    assert "eval_losses" in res.stdout

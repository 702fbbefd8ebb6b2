"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, in subprocesses: a fake process group must not live in a
test worker, and each world is a process of its own, run alone.

* processes of fake worlds trace reduced configs: the reference test's
  four small-mesh cases on a (4, 2) mesh, each ``ok`` with the argument
  bytes that the JAX specs give; a (1, 1) mesh, where a device's FLOPs
  are the unsharded trace's; the consolidation on (2, 2, 2), all-reduces
  over ``pod`` only; the sequence-parallel and MoE-pinned variants;
* gloo ranks on the CPU run the mesh paths on real values: two of them
  ``pod_consolidate`` over ``pod`` against JAX ``pod_consolidate``, and
  forward, decode (a sequence-sharded cache) and the loss's gradients of
  reduced models on a (1, 2) mesh against the plain path; four of them
  the same on the batch-sharded layouts of the production meshes, a
  (2, 2) ("data", "model") mesh and a (2, 1, 2) ("pod", "data", "model")
  one;
* the recorded sweep, where there is one, is complete and green.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import canonical_names
from repro.configs import get_config as jax_get_config
from repro.launch import specs as jspecs
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro.models import sharding as jshd
from repro.models.config import INPUT_SHAPES, ShapeConfig
from repro.train import consolidate as jcons

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TIMEOUT = 120
SMALL = [("llama3.2-1b", "train"), ("qwen3-moe-235b-a22b", "decode"),
         ("rwkv6-7b", "decode"), ("whisper-tiny", "train")]
# the reduced families whose mesh paths run on two gloo ranks; on four,
# the batch-sharded (2, 2) mesh takes each kind of block once (internvl2's
# are granite's) and the (2, 1, 2) pod mesh the MoE one (rows and experts
# sharded together)
MESH_ARCHS = ["granite-34b", "qwen3-moe-235b-a22b", "rwkv6-7b",
              "hymba-1.5b", "internvl2-2b"]
BATCH_ARCHS = MESH_ARCHS[:4]
POD_ARCHS = ["qwen3-moe-235b-a22b"]
# Each subprocess world is held to TIMEOUT, and runs alone, once the one
# before it has ended: side by side on a busy machine they slowed each
# other past it (a busy machine ran a world 2-6x slower).  So the work
# is cut into worlds of 6-20 s each on an idle machine.  The fake worlds'
# jobs (``FAKE_SNIPPET``):
FAKE_STAGES = [
    ["small:llama3.2-1b:train", "small:qwen3-moe-235b-a22b:decode",
     "seq_parallel", "moe_pinned"],
    ["small:rwkv6-7b:decode", "small:whisper-tiny:train"],
    ["consolidate", "production", "one"],
]
# The gloo worlds (``GLOO_SNIPPET``): the mesh's name, the ranks, the
# mesh as ``make_host_mesh(data, model, pod)`` takes it, the batch, the
# reduced configs, and the phases: "forward" (forward and decode),
# "loss" (the loss, its gradients and the MoE forms).  The pod mesh's
# DTensor dispatch costs 4x the (2, 2) mesh's, so its two phases run in
# two worlds.  The first world also runs the consolidation.
BOTH = ("forward", "loss")
GLOO_STAGES = [
    ("1x2", 2, (1, 2, 1), 2, MESH_ARCHS[:3], BOTH),
    ("1x2", 2, (1, 2, 1), 2, MESH_ARCHS[3:], BOTH),
    *(("2x2", 4, (2, 2, 1), 4, [arch], BOTH) for arch in BATCH_ARCHS),
    ("2x1x2", 4, (1, 2, 2), 4, POD_ARCHS, ("forward",)),
    ("2x1x2", 4, (1, 2, 2), 4, POD_ARCHS, ("loss",)),
]


class FakeMesh:
    def __init__(self, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(tuple(axes.values()))


FAKE_SNIPPET = textwrap.dedent("""
    import dataclasses, json, sys
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)          # fake tensors: nothing computes
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch.dryrun import dryrun_consolidate, dryrun_one
    from repro_torch.models.config import ShapeConfig

    def run(job):
        # one job in a fake world of its own
        if job.startswith("small:"):
            _, arch, kind = job.split(":")
            M.open_fake_world(8)
            return dryrun_one(
                arch, "t", save=False,
                mesh=M.make_host_mesh(4, 2, device="cpu"),
                cfg=get_config(arch).reduced(),
                shape=ShapeConfig("t", 64, 8, kind))
        if job == "seq_parallel":
            M.open_fake_world(8)
            return dryrun_one(
                "llama3.2-1b", "train_4k", save=False,
                mesh=M.make_host_mesh(4, 2, device="cpu"),
                seq_parallel=True, cfg=get_config("llama3.2-1b").reduced(),
                shape=ShapeConfig("train_4k", 64, 8, "train"))
        if job == "moe_pinned":
            M.open_fake_world(8)
            cfg = dataclasses.replace(
                get_config("qwen3-moe-235b-a22b").reduced(),
                moe_expert_axis="model", batch_shard_axes=("data",))
            return dryrun_one(
                "qwen3-moe-235b-a22b", "t", save=False,
                mesh=M.make_host_mesh(4, 2, device="cpu"), cfg=cfg,
                shape=ShapeConfig("t", 64, 8, "prefill"))
        if job == "consolidate":
            M.open_fake_world(8)
            return dryrun_consolidate(
                "llama3.2-1b", save=False,
                mesh=M.make_host_mesh(2, 2, 2, device="cpu"),
                cfg=get_config("llama3.2-1b").reduced())
        if job == "production":
            M.open_fake_world(256)
            prod = M.make_production_mesh()
            return {{"names": list(prod.mesh_dim_names),
                     "shape": list(prod.shape),
                     "chips": M.mesh_chip_count(prod)}}
        assert job == "one"
        M.open_fake_world(1)
        return dryrun_one(
            "llama3.2-1b", "t", save=False,
            mesh=M.make_host_mesh(1, 1, device="cpu"),
            cfg=get_config("llama3.2-1b").reduced(),
            shape=ShapeConfig("t", 64, 8, "train"), global_flops=True)

    for job in {jobs!r}:
        rec = run(job)
        M.close_world()
        print("RESULT", json.dumps([job, rec]), flush=True)
""")


def _run_world(code: str, ranks: int = 1) -> list:
    """Runs ``code`` in one process a rank (its argument) to the end,
    within TIMEOUT of the start; the ranks' standard outputs."""
    deadline = time.monotonic() + TIMEOUT
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(ranks)]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
        return outs
    finally:
        for p in procs:
            p.kill()


class Worlds:
    """The subprocess worlds, each run on first use and one at a time,
    and their results kept; the consolidation's inputs in ``x`` and
    ``steps``."""

    def __init__(self, tmp):
        self.tmp, self.results = tmp, {}
        rng = np.random.default_rng(11)
        # bf16-representable values, so both dtypes start from the same
        # copies
        x = rng.standard_normal((2, 6, 10)).astype(np.float32)
        self.x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                            .astype(jnp.float32))
        self.steps = np.array([3.0, 5.0], np.float32)
        np.savez(tmp / "inputs.npz", x=self.x, steps=self.steps)

    def fake(self, job: str) -> dict:
        """The record of ``job``, from its fake world."""
        i = next(i for i, jobs in enumerate(FAKE_STAGES) if job in jobs)
        if ("fake", i) not in self.results:
            out, = _run_world(FAKE_SNIPPET.format(src=SRC,
                                                  jobs=FAKE_STAGES[i]))
            self.results["fake", i] = dict(
                json.loads(line[len("RESULT "):])
                for line in out.splitlines() if line.startswith("RESULT "))
        return self.results["fake", i][job]

    def gloo(self, i: int) -> dict:
        """The output of gloo world ``i`` (``GLOO_STAGES``)."""
        if ("gloo", i) not in self.results:
            _, ranks, sizes, batch, archs, phases = GLOO_STAGES[i]
            result = self.tmp / f"gloo{i}.json"
            code = GLOO_SNIPPET.format(
                src=SRC, world=ranks, store=str(self.tmp / f"store{i}"),
                inputs=str(self.tmp / "inputs.npz"), result=str(result),
                consolidate=i == 0, sizes=sizes, batch=batch, archs=archs,
                phases=phases)
            _run_world(code, ranks)
            with open(result) as f:
                self.results["gloo", i] = json.load(f)
        return self.results["gloo", i]

    def errs(self, mesh: str, arch: str) -> dict:
        """``arch``'s errors against the plain path on ``mesh``, from
        every world that runs a phase of it."""
        e = {}
        for i, st in enumerate(GLOO_STAGES):
            if st[0] == mesh and arch in st[4]:
                e.update(self.gloo(i)["errs"][arch])
        return e


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return Worlds(tmp_path_factory.mktemp("worlds"))


def _local_bytes(shape, spec, dtype, sizes) -> int:
    n = 1
    for s, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        div = int(np.prod([sizes[a] for a in names])) if names else 1
        assert s % div == 0
        n *= s // div
    return n * jnp.dtype(dtype).itemsize


def jax_argument_bytes(arch: str, kind: str, sizes: dict) -> int:
    """Per-device argument bytes of the reference's ``input_specs`` for a
    reduced config at (seq 64, batch 8), from its ShapeDtypeStructs and
    the specs its resolvers give on a mesh of ``sizes``."""
    cfg = jax_get_config(arch).reduced()
    shape = ShapeConfig("t", 64, 8, kind)
    mesh = FakeMesh(sizes)
    params, axes = jmodel.init_params(cfg, abstract=True)

    def param_bytes(tree, ax, dtype=None):
        total = 0
        for k, v in tree.items():
            if isinstance(v, dict):
                total += param_bytes(v, ax[k], dtype)
            else:
                total += _local_bytes(v.shape, jshd.param_pspec(
                    ax[k], v.shape, mesh), dtype or v.dtype, sizes)
        return total

    total = param_bytes(params, axes)
    if kind == "train":
        total += 2 * param_bytes(params, axes, jnp.float32) + 4
        for v in jspecs.abstract_batch(cfg, shape).values():
            total += _local_bytes(v.shape, jshd.data_pspec(v.shape, mesh),
                                  v.dtype, sizes)
        return total
    seq_axis = jspecs.decode_seq_axis(cfg, shape)
    cache, cax = jcache.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   abstract=True)
    for k, v in cache.items():
        total += _local_bytes(v.shape, jshd.cache_pspec(
            cax[k], v.shape, mesh, seq_axis), v.dtype, sizes)
    token = (shape.global_batch,)
    total += _local_bytes(token, jshd.data_pspec(token, mesh), jnp.int32,
                          sizes)
    return total + 4                                  # pos, int32


@pytest.mark.parametrize("arch,kind", SMALL)
def test_small_mesh_dryrun_subprocess(worlds, arch, kind):
    """A reduced config on a fake 8-rank (4, 2) mesh: ``ok``, a device's
    FLOPs above 0, and the argument bytes of the JAX specs."""
    rec = worlds.fake(f"small:{arch}:{kind}")
    assert rec["status"] == "ok"
    assert rec["flops_per_device"] > 0
    assert rec["memory_analysis"]["argument_size_bytes"] == \
        jax_argument_bytes(arch, kind, {"data": 4, "model": 2})
    assert rec["memory_analysis"]["generated_code_size_bytes"] is None
    assert rec["memory_analysis"]["temp_size_bytes"] > 0
    assert rec["collective_bytes_per_device"]["total"] > 0


def test_one_rank_mesh_flops_equal_unsharded(worlds):
    rec = worlds.fake("one")
    assert rec["status"] == "ok"
    assert rec["flops_per_device"] == rec["flops_global"] > 0


def test_consolidate_all_reduces_over_pod_only(worlds):
    rec = worlds.fake("consolidate")
    assert rec["status"] == "ok"
    assert set(rec["collective_bytes_per_device"]) == {"all-reduce",
                                                        "total"}
    assert rec["collective_mesh_dims"] == {"all-reduce": ["pod"]}
    assert rec["collective_ops"] > 0


def test_production_mesh_over_fake_world(worlds):
    assert worlds.fake("production") == {
        "names": ["data", "model"], "shape": [16, 16], "chips": 256}


def test_seq_parallel_and_moe_pins(worlds):
    """The model's pins under a mesh: sequence parallelism puts
    collectives inside the blocks; the MoE buffer pins trace."""
    sp = worlds.fake("seq_parallel")
    assert sp["status"] == "ok"
    assert sp["collective_bytes_scoped"]["body"]["total"] > 0
    moe = worlds.fake("moe_pinned")
    assert moe["status"] == "ok"
    assert moe["collective_bytes_scoped"]["body"]["total"] > 0


GLOO_SNIPPET = textwrap.dedent("""
    import dataclasses, json, sys
    sys.path.insert(0, {src!r})
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(2)          # small tensors, ranks side by side
    rank, world = int(sys.argv[1]), {world}
    dist.init_process_group("gloo", store=dist.FileStore({store!r}, world),
                            rank=rank, world_size=world)
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch.specs import decode_seq_axis, param_shardings
    from repro_torch.models import sharding as shd
    from repro_torch.models.cache import cache_axes, init_cache
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import forward, init_params, loss_fn
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.train.consolidate import pod_consolidate
    ARCHS = {archs!r}
    PHASES = {phases!r}
    torch.manual_seed(0)
    out = {{}}

    if {consolidate}:
        # pod_consolidate over pod = 2 against the JAX package's
        pods = M.make_host_mesh(1, 1, 2, device="cpu")
        inp = np.load({inputs!r})
        steps = torch.from_numpy(inp["steps"])
        for key in ("f32", "bf16"):
            x = torch.from_numpy(inp["x"])
            if key == "bf16":
                x = x.to(torch.bfloat16)
            d = distribute_tensor(x, pods, shd.to_placements(
                ("pod", None, "model"), pods))
            res = pod_consolidate({{"p": d}}, steps)["p"]
            out[key] = res.full_tensor().float().numpy().tolist()
            out[key + "_placements"] = [str(p) for p in res.placements]


    def mesh_errs(mesh, archs, B):
        # the mesh paths on real values against the plain path
        return {{arch: arch_errs(mesh, arch, B) for arch in archs}}


    def distribute(model, mesh):
        sh = param_shardings(model, mesh)
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            setattr(mod, leaf, torch.nn.Parameter(distribute_tensor(
                p.detach(), mesh, shd.to_placements(sh[name], mesh)),
                requires_grad=False))
        return model


    def arch_errs(mesh, arch, B):
        # every rank runs the mesh path; rank 0 alone the plain one, and
        # holds the two (the other ranks' errors stay 0)
        lead = rank == 0

        def dt(x, spec):
            return distribute_tensor(x, mesh, shd.to_placements(spec, mesh))

        def err(want, got):
            got = got.full_tensor()
            return float((want - got).abs().max()) if lead else 0.0

        cfg = get_config(arch).reduced()
        plain = init_params(cfg, seed=1, device="cpu") if lead else None
        meshed = distribute(init_params(cfg, seed=1, device="cpu"), mesh)
        g = torch.Generator().manual_seed(2)
        S = 12
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
        batch = {{"tokens": tokens, "labels": tokens}}
        dbatch = {{k: dt(v, shd.data_pspec(tuple(v.shape), mesh))
                  for k, v in batch.items()}}
        if cfg.family == "vlm":
            batch["patches"] = torch.randn(B, cfg.enc_seq, cfg.d_model,
                                           generator=g)
            dbatch["patches"] = dt(batch["patches"], (None, None, None))
        e = {{}}
        if "forward" in PHASES:
            with torch.no_grad(), implicit_replication():
                want = forward(plain, cfg, batch)[0] if lead else None
                e["forward"] = err(want, forward(meshed, cfg, dbatch)[0])
            # decode with the cache's sequence sharded over "model"; on
            # a mesh with a data axis of 2 also over "data" (long_500k's
            # layout)
            ps, ms = make_serve_step(cfg), make_serve_step(cfg, True)
            axes = cache_axes(cfg)
            sc = ShapeConfig("t", 8, B, "decode")
            seq_axes = {{"decode": decode_seq_axis(cfg, sc, 2) or "model"}}
            if shd.axis_sizes(mesh)["data"] == 2 and cfg.family != "ssm":
                seq_axes["decode_long"] = "data"
            for key, seq_axis in seq_axes.items():
                pc = init_cache(cfg, B, 8, device="cpu")
                dc = {{k: dt(v.clone(), shd.cache_pspec(
                    axes[k], tuple(v.shape), mesh, seq_axis))
                      for k, v in pc.items()}}
                tok, dtok = tokens[:, 0], dt(tokens[:, 0], (None,))
                worst, lp = 0.0, None
                with torch.no_grad(), implicit_replication():
                    for pos in range(3):
                        if lead:
                            tok, pc, lp = ps(plain, pc, tok, pos)
                        dtok, dc, lm = ms(meshed, dc, dtok, pos)
                        worst = max(worst, err(lp, lm))
                e[key] = worst
        if "loss" in PHASES:
            # the loss and its gradients (the vocab-sharded loss)
            for m in (plain, meshed) if lead else (meshed,):
                for p in m.parameters():
                    p.requires_grad_(True)
            if lead:
                lw, _ = loss_fn(plain, cfg, batch)
                gw = torch.autograd.grad(lw, list(plain.parameters()))
            with implicit_replication():
                lm, _ = loss_fn(meshed, cfg, dbatch)
                gm = torch.autograd.grad(lm, list(meshed.parameters()))
            e["loss"] = err(lw, lm) if lead else err(None, lm)
            if cfg.family == "moe":
                # the grouped form (the full configs' many experts; a
                # reduced one has too few to reach it) on rows sharded as
                # the residual stream's, the experts as the weights', the
                # buffer pins on; on two ranks the flat form, which no
                # config runs
                from repro_torch.models.moe import (moe_ffn_flat,
                                                    moe_ffn_grouped)
                h = torch.randn(B, S, cfg.d_model, generator=g)
                pinned = dataclasses.replace(
                    cfg, moe_expert_axis="model",
                    batch_shard_axes=shd.batch_axes(mesh))
                forms = {{"grouped": (moe_ffn_grouped, pinned, shd.data_pspec(
                    (B, S, cfg.d_model), mesh))}}
                if world == 2:
                    forms["flat"] = (moe_ffn_flat, cfg, (None, None, None))
                for key, (form, c, spec) in forms.items():
                    with torch.no_grad(), implicit_replication():
                        want = (form(plain.blocks[0], h, c)[0] if lead
                                else None)
                        e[key] = err(want, form(meshed.blocks[0],
                                                dt(h, spec), c)[0])
            rel = []
            for i, b in enumerate(gm):
                full = b.full_tensor()
                if lead:
                    a = gw[i]
                    rel.append(float((a - full).abs().max() /
                                     (a.abs().max() + 1e-30)))
            e["grad"] = max(rel) if lead else 0.0
        return e

    out["errs"] = mesh_errs(M.make_host_mesh(*{sizes!r}, device="cpu"),
                            ARCHS, {batch})
    if rank == 0:
        with open({result!r}, "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
""")


def test_gloo_pod_consolidate_matches_reference(worlds):
    out, x, steps = worlds.gloo(0), worlds.x, worlds.steps
    want32 = np.asarray(jcons.pod_consolidate({"p": jnp.asarray(x)},
                                              jnp.asarray(steps))["p"])
    np.testing.assert_allclose(np.asarray(out["f32"]), want32, rtol=1e-6,
                               atol=0)
    # replicated over pod after the all-reduce; the spec's "model" dim
    # (one rank) stays sharded
    assert out["f32_placements"] == ["R", "R", "S(1)"]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wantb = np.asarray(jcons.pod_consolidate({"p": xb}, jnp.asarray(steps))
                       ["p"].astype(jnp.float32))
    got = np.asarray(out["bf16"], np.float32)
    # within one bf16 ulp of the reference's value
    ulp = np.spacing(np.abs(wantb).astype(np.float32)) * 2 ** 16
    assert np.all(np.abs(got - wantb) <= ulp)


def _assert_close_to_plain(e: dict):
    assert e["forward"] < 1e-4, e
    assert e["decode"] < 1e-4, e
    assert e.get("decode_long", 0.0) < 1e-4, e
    assert e["loss"] < 1e-5, e
    assert e["grad"] < 1e-3, e
    assert e.get("flat", 0.0) < 1e-4, e
    assert e.get("grouped", 0.0) < 1e-4, e


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_gloo_mesh_paths_match_plain(worlds, arch):
    """Forward, three decode steps with the sequence-sharded cache
    (attention merged across the shards), the loss and every gradient of
    a reduced model (and for the moe family the flat form, which no
    config runs) on a (1, 2) mesh of two gloo ranks, against the plain
    path (float32; the sums run in another order: each gradient
    within 1e-3 of its own largest element)."""
    _assert_close_to_plain(worlds.errs("1x2", arch))


@pytest.mark.parametrize("mesh,arch",
                         [("2x2", a) for a in BATCH_ARCHS]
                         + [("2x1x2", a) for a in POD_ARCHS])
def test_gloo_batch_sharded_mesh_paths_match_plain(worlds, mesh, arch):
    """The same on four gloo ranks, with the batch sharded as on the
    production meshes (4 sequences): a (2, 2) ("data", "model") mesh, 2
    a shard, where decode also runs on a cache sharded over "data"
    (long_500k's layout), and for the MoE family a (2, 1, 2) ("pod",
    "data", "model") one, the batch over pod and data (one sequence a
    shard), the experts over model; the same tolerances."""
    _assert_close_to_plain(worlds.errs(mesh, arch))


def test_torch_dryrun_artifacts_green():
    """The recorded sweep must cover every (arch x shape x mesh) with
    status ok (or the documented whisper long_500k skip), and every
    consolidation record must be ok with all-reduces only."""
    d = os.path.join(os.path.dirname(__file__), "..", "experiments",
                     "dryrun_torch")
    if not os.path.isdir(d):
        pytest.skip("dry-run sweep not yet recorded")
    missing, bad = [], []
    for arch in canonical_names():
        for shape in INPUT_SHAPES:
            for mesh in ("pod16x16", "pod2x16x16"):
                p = os.path.join(d, f"{arch}__{shape}__{mesh}.json")
                if not os.path.exists(p):
                    missing.append((arch, shape, mesh))
                    continue
                with open(p) as f:
                    rec = json.load(f)
                if rec["status"] == "error":
                    bad.append((arch, shape, mesh))
                if rec["status"] == "skipped":
                    assert arch == "whisper-tiny" and shape == "long_500k"
        p = os.path.join(d, f"{arch}__consolidate__pod2x16x16.json")
        if not os.path.exists(p):
            missing.append((arch, "consolidate", "pod2x16x16"))
            continue
        with open(p) as f:
            rec = json.load(f)
        if rec["status"] != "ok" or set(rec["collective_bytes_per_device"]) \
                != {"all-reduce", "total"}:
            bad.append((arch, "consolidate", "pod2x16x16"))
    assert not missing, f"missing dry-runs: {missing[:5]}"
    assert not bad, f"failed dry-runs: {bad[:5]}"

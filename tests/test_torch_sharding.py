"""The port's sharding slice against the JAX package's, in process and
with no process group: the logical axes of every parameter and cache
entry, the specs of parameters, optimizer state, cache and batch on both
production meshes (``repro.models.sharding`` on the ``FakeMesh`` of
``tests/test_sharding_and_dryrun.py``), the long-context policy, the
abstract optimizer state, the consolidation specs, the chunked WKV scan
that the mesh path takes, and ``make_serve_step(seq_sharded=True)``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import canonical_names
from repro.configs import get_config as jax_get_config
from repro.launch import specs as jspecs
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro.models import rwkv as jrwkv
from repro.models import sharding as jshd
from repro.models.config import INPUT_SHAPES
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.models import rwkv, sharding as shd
from repro_torch.models.cache import cache_axes, init_cache
from repro_torch.models.model import init_params, param_axes
from repro_torch.serve.serve_step import make_serve_step
from repro_torch.train import consolidate
from repro_torch.train import optimizer as topt

ARCHS = canonical_names()
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """Just enough Mesh surface for the JAX resolvers (the class of
    ``tests/test_sharding_and_dryrun.py``)."""

    def __init__(self, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(tuple(axes.values()))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jmodel.init_params(jax_get_config(arch), abstract=True)


def _flat_jax(tree: dict) -> dict:
    """The JAX tree by the port's parameter names: top-level leaves as
    they are, each stacked ``blocks``/``enc`` entry split per layer."""
    out = {}
    for name, leaf in tree.items():
        if name in ("blocks", "enc"):
            for sub, v in leaf.items():
                n = (v.shape[0] if hasattr(v, "shape") else None)
                for i in range(n if n is not None else 0):
                    out[f"{name}.{i}.{sub}"] = v
        else:
            out[name] = leaf
    return out


def _flat_axes(params: dict, axes: dict) -> dict:
    out = {}
    for name, ax in axes.items():
        if name in ("blocks", "enc"):
            for sub, a in ax.items():
                assert a[0] == "layer"
                for i in range(params[name][sub].shape[0]):
                    out[f"{name}.{i}.{sub}"] = tuple(a[1:])
        else:
            out[name] = tuple(ax)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_reference(arch):
    """Every parameter's logical axes, at full size, are the JAX
    ``ParamFactory``'s without the stacked layer axis, and the meta
    model's shapes are the reference's per-layer shapes."""
    jparams, jaxes = _jax_params(arch)
    want = _flat_axes(jparams, jaxes)
    cfg = get_config(arch)
    model = init_params(cfg, device="meta")
    got = param_axes(model)
    assert got == want
    assert got == param_axes(cfg)
    assert list(got) == [n for n, _ in model.named_parameters()]
    flat = _flat_jax(jparams)
    for name, p in model.named_parameters():
        j = flat[name]
        jshape = j.shape[1:] if name.startswith(("blocks.", "enc.")) \
            else j.shape
        assert tuple(p.shape) == tuple(jshape), name
        assert p.device.type == "meta"
        assert str(p.dtype).split(".")[-1] == str(j.dtype)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    """Each parameter's spec (and so each opt-state moment's) on both
    production meshes is JAX ``param_pspec`` of the stacked tensor
    without its layer entry; ``input_specs``' opt state and batch specs
    are the reference's."""
    jparams, jaxes = _jax_params(arch)
    fake = FakeMesh(MESHES[mesh])
    want = {}
    for name, ax in jaxes.items():
        if name in ("blocks", "enc"):
            for sub, a in ax.items():
                spec = tuple(jshd.param_pspec(a, jparams[name][sub].shape,
                                              fake))
                assert spec[0] is None
                for i in range(jparams[name][sub].shape[0]):
                    want[f"{name}.{i}.{sub}"] = spec[1:]
        else:
            want[name] = tuple(jshd.param_pspec(ax, jparams[name].shape,
                                                fake))
    cfg = get_config(arch)
    # the port's resolvers take the JAX FakeMesh, a dict, or a DeviceMesh
    for m in (fake, MESHES[mesh]):
        got = specs.param_shardings(init_params(cfg, device="meta"), m)
        assert got == want
    args, sh, _ = specs.input_specs(cfg, INPUT_SHAPES["train_4k"],
                                    MESHES[mesh])
    opt_sh = sh[1]
    assert opt_sh.step == () and opt_sh.mu == want and opt_sh.nu == want
    batch = jspecs.abstract_batch(jax_get_config(arch),
                                  INPUT_SHAPES["train_4k"])
    for k, v in batch.items():
        assert sh[2][k] == tuple(jshd.data_pspec(v.shape, fake)), k
        assert tuple(args[2][k].shape) == tuple(v.shape)
        assert str(args[2][k].dtype).split(".")[-1] == str(v.dtype)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_token_specs_equal_reference(arch, mesh, shape):
    """The decode cache's axes, shapes, dtypes and specs (with
    ``decode_seq_axis``) and the token's spec are the reference's."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    sc = INPUT_SHAPES[shape]
    fake = FakeMesh(MESHES[mesh])
    jc, jax_axes = jcache.init_cache(jcfg, sc.global_batch, sc.seq_len,
                                     abstract=True)
    assert cache_axes(cfg) == {k: tuple(v) for k, v in jax_axes.items()}
    seq_axis = jspecs.decode_seq_axis(jcfg, sc)
    assert specs.decode_seq_axis(cfg, sc) == seq_axis
    args, sh, meta = specs.input_specs(cfg, sc, MESHES[mesh])
    assert meta["seq_sharded"] == (seq_axis is not None)
    assert list(args[1]) == list(jc)
    for k, v in jc.items():
        assert tuple(args[1][k].shape) == tuple(v.shape), k
        assert str(args[1][k].dtype).split(".")[-1] == str(v.dtype), k
        assert sh[1][k] == tuple(jshd.cache_pspec(jax_axes[k], v.shape, fake,
                                                  seq_axis)), k
    assert sh[2] == tuple(jshd.data_pspec((sc.global_batch,), fake))
    assert sh[3] == ()


def test_init_cache_meta_matches_plain():
    cfg = get_config("hymba-1.5b").reduced()
    meta = init_cache(cfg, 2, 8, device="meta")
    plain = init_cache(cfg, 2, 8, device="cpu")
    assert list(meta) == list(plain) == list(cache_axes(cfg))
    for k in plain:
        assert meta[k].device.type == "meta"
        assert meta[k].shape == plain[k].shape
        assert meta[k].dtype == plain[k].dtype


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_long_context_policy_and_seq_axis(arch, shape):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    sc = INPUT_SHAPES[shape]
    assert specs.long_context_policy(cfg, sc) == \
        jspecs.long_context_policy(jcfg, sc)
    for size in (16, 8, 1):
        assert specs.decode_seq_axis(cfg, sc, size) == \
            jspecs.decode_seq_axis(jcfg, sc, size)


# the six cases of tests/test_sharding_and_dryrun.py's
# test_param_pspec_priority_and_fallback, and both resolvers' answers
PSPEC_CASES = [
    (("layer", "d_model", "heads", None), (22, 2048, 32, 64),
     (None, None, "model", None)),
    (("layer", "experts", "d_model", "d_ff"), (64, 8, 6144, 32768),
     (None, None, None, "model")),
    (("layer", "d_model", "heads", None), (4, 384, 6, 64),
     (None, None, None, None)),
    (("layer", "d_model", "heads", None), (4, 4096, 6, 512),
     (None, "model", None, None)),
    (("layer", "heads", None), (2, 6, 7), (None, None, None)),
    (("vocab", "d_model"), (92553, 2048), (None, "model")),
]


@pytest.mark.parametrize("logical,shape,want", PSPEC_CASES)
def test_param_pspec_priority_and_fallback(logical, shape, want):
    mesh = FakeMesh({"data": 16, "model": 16})
    assert shd.param_pspec(logical, shape, mesh) == want
    assert jshd.param_pspec(logical, shape, mesh) == P(*want)


def test_data_pspec_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    m3 = {"pod": 2, "data": 16, "model": 16}
    for shape, seq in (((256, 4096), None), ((1, 524288), 1), ((3, 32), 1),
                       ((32,), None)):
        for m in (m3, {"data": 16, "model": 16}):
            assert shd.data_pspec(shape, m, seq) == tuple(
                jshd.data_pspec(shape, FakeMesh(m), seq))
    spec = (("pod", "data"), None, "model")
    assert shd.to_placements(spec, m3) == [Shard(0), Shard(0), Shard(2)]
    assert shd.to_placements((None, None), m3) == [Replicate()] * 3
    assert shd.local_shape((256, 7, 4096), spec, m3) == (8, 7, 256)
    with pytest.raises(ValueError):
        shd.to_placements((("data", "pod"),), m3)
    with pytest.raises(ValueError):
        shd.local_shape((6,), ("model",), m3)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-235b-a22b",
                                  "whisper-tiny"])
def test_abstract_opt_state_matches_reference(arch):
    jparams, _ = _jax_params(arch)
    jst = jopt.abstract_opt_state(jparams, jopt.OptConfig())
    _, params = specs.abstract_params(get_config(arch))
    st = topt.abstract_opt_state(params, topt.OptConfig())
    assert tuple(st.step.shape) == tuple(jst.step.shape) == ()
    assert st.step.dtype == torch.int32 and str(jst.step.dtype) == "int32"
    flat_mu, flat_nu = _flat_jax(jst.mu), _flat_jax(jst.nu)
    assert list(st.mu) == list(params) == list(st.nu)
    for name, p in params.items():
        for t, j in ((st.mu[name], flat_mu[name]), (st.nu[name],
                                                     flat_nu[name])):
            jshape = j.shape[1:] if name.startswith(("blocks.", "enc.")) \
                else j.shape
            assert tuple(t.shape) == tuple(jshape) == tuple(p.shape)
            assert t.dtype == torch.float32 and str(j.dtype) == "float32"
            assert t.device.type == "meta"


def test_pod_consolidate_shardings_match_reference():
    """The input spec is ``pod`` ahead of each parameter's, the output the
    parameter's: the reference's ``P(axis, *spec)``."""
    m = MESHES["2x16x16"]
    got_in, got_out = consolidate.pod_consolidate_shardings(
        specs.param_shardings(init_params(get_config("grok-1-314b"),
                                          device="meta"), m))
    for name, spec in got_out.items():
        assert got_in[name] == ("pod",) + spec
        assert shd.to_placements(got_in[name], m)[0] == \
            shd.to_placements(("pod",), m)[0]
    assert got_in["blocks.0.we_gate"] == ("pod", None, None, "model")


def test_wkv_chunked_matches_reference_scan():
    """The chunked WKV6 form that the mesh path runs against the JAX
    package's sequential ``wkv_scan`` on the same seeded inputs, float32,
    with chunks that cut the sequence unevenly."""
    rng = np.random.default_rng(3)
    B, S, H, D = 2, 45, 3, 16
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, D)))).astype(
        np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32)
    st = rng.standard_normal((B, H, D, D)).astype(np.float32)
    jo, js = jrwkv.wkv_scan(*(jax.numpy.asarray(a) for a in
                              (r, k, v, w, u, st)))
    for chunk in (1, 8, 32, 64):
        o, s = rwkv.wkv_chunked(*(torch.from_numpy(a) for a in
                                  (r, k, v, w, u, st)), chunk=chunk)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hymba-1.5b"])
def test_serve_step_seq_sharded_writes_same_cache(arch):
    """``make_serve_step(seq_sharded=True)`` writes the new token's K/V
    by a select over the sequence: the same cache, logits and tokens as
    the slice write."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    model = init_params(cfg, seed=4, device="cpu")
    tok = torch.tensor([3, 9])
    out = {}
    for sharded in (False, True):
        step = make_serve_step(cfg, seq_sharded=sharded)
        cache = init_cache(cfg, 2, 8, device="cpu")
        t = tok
        for pos in range(3):
            t, cache, logits = step(model, cache, t, pos)
        out[sharded] = (t, cache, logits)
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][2], out[True][2])
    for k in out[False][1]:
        assert torch.equal(out[False][1][k], out[True][1][k]), k


def test_host_mesh_defaults_to_the_card():
    """``make_host_mesh`` runs on the card unless asked for the CPU; with
    no CUDA it raises before touching any process group."""
    from repro_torch.launch import mesh as M
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.make_host_mesh(1, 1)
    assert M.PEAK_FLOPS_BF16 == 989e12 and M.HBM_BW == 3.35e12


def test_collective_accounting_convention():
    """``utils.collectives`` keeps ``repro.utils.hlo``'s convention: an
    all-reduce counts twice its result bytes, the others once; scopes
    split the totals; the largest single collectives come first."""
    from repro_torch.utils import collectives as coll
    ops = [coll.Op("_c10d_functional.all_reduce.default", "all-reduce",
                   "body", 100, 100, 0, ((25,),), "g0"),
           coll.Op("_c10d_functional.all_gather_into_tensor.default",
                   "all-gather", "entry", 400, 100, 0, ((100,),), "g1"),
           coll.Op("aten.mm.default", "", "body", 8, 16, 64, ((2, 2),)),
           coll.Op("_c10d_functional.reduce_scatter_tensor.default",
                   "reduce-scatter", "body", 30, 120, 0, ((3,),), "g1")]
    assert coll.collective_bytes(ops) == {
        "all-reduce": 200, "all-gather": 400, "reduce-scatter": 30,
        "total": 630}
    assert coll.collective_bytes_by_scope(ops) == {
        "entry": {"all-gather": 400, "total": 400},
        "body": {"all-reduce": 200, "reduce-scatter": 30, "total": 230}}
    assert [r[:2] for r in coll.dominant_collectives(ops, top=2)] == [
        ("all-gather", 400), ("all-reduce", 100)]
    assert coll.count_ops(ops, "all-reduce") == 1
    assert coll.count_ops(ops, "aten.mm") == 1


def test_recorder_counts_local_flops_and_peak_storage():
    """On plain (fake) tensors the recorder counts each matmul's FLOPs and
    the peak of the storage its ops keep alive."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.utils import collectives as coll
    with FakeTensorMode():
        a = torch.empty(64, 32)
        b = torch.empty(32, 16)
        rec = coll.Recorder()
        with rec:
            c = a @ b
            d = c.t().contiguous()
            del c, d
    assert rec.flops() == 2 * 64 * 32 * 16
    assert rec.peak_bytes == 2 * 64 * 16 * 4
    assert rec.live_bytes == 0
    assert not coll.collective_bytes(rec.ops)["total"]


class _GridMesh:
    """The part of a ``DeviceMesh`` that ``shard_offset`` reads: its
    sizes and this device's coordinate."""

    def __init__(self, sizes, coord):
        self.sizes, self.coord = tuple(sizes), list(coord)
        self.ndim = len(sizes)

    def size(self, i):
        return self.sizes[i]

    def get_coordinate(self):
        return self.coord


@pytest.mark.parametrize("sizes,placements", [
    ((2, 2, 2), ("S0", "R", "S0")),
    ((2, 2, 2), ("S0", "S0", "S1")),
    ((2, 1, 2), ("S0", "S0", "R")),
    ((4, 2), ("S0", "S0")),
    ((2, 4), ("R", "S0")),
])
def test_shard_offset_over_several_mesh_dims(sizes, placements):
    """Every device's first index along dim 0 under placements that shard
    it over several mesh dims equals the one DTensor's layout gives:
    the dim cut into even chunks by each sharding mesh dim in turn, the
    first mesh dim major (an independent nested split of an arange)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Shard(int(p[1])) if p.startswith("S") else Replicate()
          for p in placements]
    n = 4 * int(np.prod(sizes))
    for coord in np.ndindex(*sizes):
        piece = torch.arange(n)
        for i, p in enumerate(pl):
            if p == Shard(0):
                piece = piece.chunk(sizes[i])[coord[i]]
        got = shd.shard_offset(_GridMesh(sizes, coord), pl, 0, piece.numel())
        assert got == int(piece[0]), (coord, got, int(piece[0]))


@pytest.mark.parametrize("module", ["attention", "blocks", "cache", "mamba",
                                    "model", "moe", "rwkv", "sharding"])
def test_model_code_carries_no_dry_run_accounting(module):
    """The dry run's accounting (``utils.collectives``) wraps the model
    from ``launch.dryrun``; no module of ``models/`` imports it."""
    import ast
    import importlib
    mod = importlib.import_module(f"repro_torch.models.{module}")
    tree = ast.parse(open(mod.__file__).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [f"{n.module}.{a.name}" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module
              for a in n.names]
    assert not [n for n in names
                if n.startswith(("repro_torch.utils", "repro_torch.launch"))]

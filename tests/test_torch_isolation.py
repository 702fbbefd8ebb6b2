"""The port stands alone: no ``jax`` and no ``repro`` import, anywhere in
``src/repro_torch``, ``chip_smoke.py``, ``chip_mutants.py``,
``chip_compare.py`` or ``chip_paths.py``, and it serves all ten configs (every family),
prefills vlm and encdec, schedules and simulates under faults, HadarE, the
env, the sanitized policy comparison and the observer included, with both
blocked; ``python -m repro_torch.obs`` runs with both blocked too, and so
does training: a train step of each family on both paths, a checkpoint
round trip and a HadarE-scheduled run."""
import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.lineno, node.module.split(".")[0]


def test_no_jax_or_repro_imports():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "chip_mutants.py",
              REPO / "chip_compare.py", REPO / "chip_paths.py"]
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"src/repro_torch/models/rwkv.py",
            "src/repro_torch/models/mamba.py",
            "src/repro_torch/configs/hymba_1_5b.py",
            "src/repro_torch/configs/internvl2_2b.py",
            "src/repro_torch/configs/whisper_tiny.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/configs/qwen3_moe_235b_a22b.py",
            "src/repro_torch/configs/grok_1_314b.py",
            "src/repro_torch/configs/tinyllama_1_1b.py",
            "src/repro_torch/configs/granite_34b.py",
            "src/repro_torch/configs/qwen2_5_32b.py",
            "src/repro_torch/kernels/rwkv6_scan.py",
            "src/repro_torch/configs/rwkv6_7b.py",
            "src/repro_torch/kernels/rmsnorm.py",
            "src/repro_torch/kernels/find_alloc.py",
            "src/repro_torch/kernels/commit_scan.py",
            "src/repro_torch/core/types.py",
            "src/repro_torch/core/utility.py",
            "src/repro_torch/core/throughput.py",
            "src/repro_torch/core/trace.py",
            "src/repro_torch/core/schedulers.py",
            "src/repro_torch/core/pricing.py",
            "src/repro_torch/core/dp.py",
            "src/repro_torch/core/batch_solver.py",
            "src/repro_torch/core/hadar.py",
            "src/repro_torch/core/simulator.py",
            "src/repro_torch/core/hadare.py",
            "src/repro_torch/sim/metrics.py",
            "src/repro_torch/sim/engine.py",
            "src/repro_torch/sim/events.py",
            "src/repro_torch/sim/faults.py",
            "src/repro_torch/sim/replay.py",
            "src/repro_torch/sim/adapters.py",
            "src/repro_torch/analysis/__init__.py",
            "src/repro_torch/analysis/invariants.py",
            "src/repro_torch/env/__init__.py",
            "src/repro_torch/env/baselines.py",
            "src/repro_torch/env/env.py",
            "src/repro_torch/env/compare.py",
            "src/repro_torch/obs/__init__.py",
            "src/repro_torch/obs/__main__.py",
            "src/repro_torch/obs/explain.py",
            "src/repro_torch/obs/metrics.py",
            "src/repro_torch/obs/trace.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/train/_tree.py",
            "src/repro_torch/train/optimizer.py",
            "src/repro_torch/train/train_step.py",
            "src/repro_torch/train/checkpoint.py",
            "src/repro_torch/train/consolidate.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/kernels/flash_attention_bwd.py",
            "src/repro_torch/kernels/rwkv6_scan_bwd.py",
            "src/repro_torch/kernels/rmsnorm_bwd.py"} <= names
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
           for f in files for line, root in _imported_roots(f)
           if root in FORBIDDEN]
    assert not bad, bad


SERVE_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
from repro_torch.configs import get_config
from repro_torch.kernels import build, flash_attention, ops, ref, rwkv6_scan
from repro_torch.launch import serve
from repro_torch.models import convert, moe, rwkv
from repro_torch.models.model import init_params
from repro_torch.serve.serve_step import Request, ServingEngine
import torch
from repro_torch.configs import list_archs
from repro_torch.models import mamba
from repro_torch.models.model import forward
for arch in list_archs():
    cfg = get_config(arch).reduced(n_layers=1, max_d_model=128)
    model = init_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(cfg, model, slots=1, max_seq=8, device="cpu")
    (r,) = eng.run([Request(0, np.arange(3), 2)])
    assert len(r.out) == 2
    print("served", arch, r.out.tolist())
    if cfg.family in ("vlm", "encdec"):
        key = "patches" if cfg.family == "vlm" else "frames"
        lg, _ = forward(model, cfg, {"tokens": torch.arange(3)[None],
                                     key: torch.randn(1, cfg.enc_seq,
                                                      cfg.d_model)})
        assert lg.shape == (1, 3, cfg.vocab_size)
        print("prefilled", arch)
from repro_torch.core.hadar import HadarScheduler
from repro_torch.core.simulator import simulate
from repro_torch.core.trace import grown_cluster, philly_trace
from repro_torch.core.types import clone_jobs
cluster = grown_cluster(40)
jobs = philly_trace(n_jobs=40, seed=1, types=cluster.gpu_types)
rounds = {s: HadarScheduler(solver=s, device="cpu").schedule(
    0.0, 360.0, clone_jobs(jobs), cluster) for s in ("numpy", "cuda")}
assert rounds["numpy"] == rounds["cuda"] and rounds["numpy"]
res = simulate(HadarScheduler(solver="numpy"), philly_trace(n_jobs=6, seed=1),
               grown_cluster(6))
print("scheduled", len(rounds["numpy"]), "jobs; simulated", res.avg_jct())
from repro_torch.core.schedulers import GavelScheduler
from repro_torch.sim import events, faults, replay
from repro_torch.sim.engine import simulate_events
cluster = grown_cluster(8)
model = faults.FailureModel(seed=3, mtbf_hours=2.0, spot_frac=0.5)
assert len(model.sample(cluster)) > 0
for sched in (HadarScheduler(solver="numpy"), GavelScheduler()):
    ev = simulate_events(sched, philly_trace(n_jobs=8, seed=2), cluster,
                         faults=model)
    assert ev.n_events > 0 and ev.evictions > 0, (ev.n_events, ev.evictions)
print("events", ev.n_events, "evictions", ev.evictions,
      len(replay.load_trace_csv("examples/traces/philly_mini.csv")),
      int(events.EventKind.RESCHEDULE))
from repro_torch.core.hadare import simulate_hadare
from repro_torch.core.trace import mix_jobs, testbed_cluster
from repro_torch.sim import adapters
cluster = testbed_cluster()
outage = faults.FailureTrace([(0, 100.0, 400.0), (1, 100.0, 400.0)])
he = simulate_hadare(mix_jobs("M-4", cluster), cluster, round_len=90.0,
                     scheduler=HadarScheduler(solver="numpy"))
hf = adapters.simulate_hadare(mix_jobs("M-4", cluster), cluster,
                              round_len=90.0, faults=outage,
                              scheduler=HadarScheduler(solver="numpy"))
assert all(p.finish_time is not None for p in he.jobs + hf.jobs)
assert hf.evictions > 0, hf.evictions
print("hadare", he.total_seconds, hf.total_seconds, hf.evictions)
import os
import repro_torch.env.compare as cmp
from repro_torch.analysis import invariants
from repro_torch.env import ClusterSchedulingEnv, SRTFScheduler, run_policy
from repro_torch.core.trace import simulation_cluster
cluster = simulation_cluster()
res, rewards = run_policy(
    ClusterSchedulingEnv(philly_trace(n_jobs=6, seed=1), cluster,
                         faults=outage, sanitize=True),
    HadarScheduler(solver="numpy"))
assert all(j.finish_time is not None for j in res.jobs) and rewards
os.environ["REPRO_SANITIZE"] = "1"
assert invariants.sanitize_enabled()
doc = cmp.compare(philly_trace(n_jobs=6, seed=1), cluster,
                  ("hadar", "srtf"), device="cpu")
assert cmp.validate_table(doc) == [], doc
print("env", res.total_seconds, len(rewards), cmp.render_table(doc))
from repro_torch import obs
with obs.session() as ob:
    ev = simulate_events(HadarScheduler(solver="cuda", device="cpu"),
                         philly_trace(n_jobs=8, seed=2), cluster,
                         faults=model)
assert obs.validate_trace(ob.trace.to_json()) == []
assert ob.metrics.counter("solver_batch_calls").value > 0
print("obs", len(ob.decisions), obs.explain_allocation(
    ob.decisions.decisions[0]).splitlines()[0])
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_serves_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", SERVE_WITHOUT_JAX],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert "served llama3.2-1b" in res.stdout
    assert "served rwkv6-7b" in res.stdout
    assert "served qwen3-moe-235b-a22b" in res.stdout
    assert "served grok-1-314b" in res.stdout
    assert "served qwen2.5-32b" in res.stdout
    for arch in ("hymba-1.5b", "internvl2-2b", "whisper-tiny"):
        assert f"served {arch}" in res.stdout
    assert "prefilled internvl2-2b" in res.stdout
    assert "prefilled whisper-tiny" in res.stdout
    assert "scheduled" in res.stdout
    assert "events" in res.stdout
    assert "hadare" in res.stdout
    assert "env" in res.stdout
    assert "obs" in res.stdout


def test_compare_cli_runs_as_a_module():
    """``python -m repro_torch.env.compare`` on the CPU, warnings as
    errors: the lazy export leaves the module to runpy."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-W", "error", "-m", "repro_torch.env.compare",
         "--device", "cpu", "--fig5", "8", "--policies", "fcfs,srtf"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "fcfs" in res.stdout and "srtf" in res.stdout


OBS_CLI_WITHOUT_JAX = """
import runpy
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch import obs
tr = obs.TraceRecorder()
tr.sim_span("interval", 0.0, 1.0)
tr.save(sys.argv[1])
sys.argv = ["python -m repro_torch.obs", "summarize", sys.argv[1]]
try:
    runpy.run_module("repro_torch.obs", run_name="__main__")
except SystemExit as stop:
    assert stop.code == 0, stop.code
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_obs_cli_runs_with_jax_and_repro_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", OBS_CLI_WITHOUT_JAX,
                          str(tmp_path / "t.json")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "sim-time/interval" in res.stdout


TRAIN_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import dataclasses
from repro_torch.configs import get_config
from repro_torch.data.pipeline import batch_for
from repro_torch.launch.train import EmuNode, run_scheduled_training
from repro_torch.models.model import batch_tensors, init_params
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step, trainable
oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
for arch in ("llama3.2-1b", "rwkv6-7b", "hymba-1.5b", "whisper-tiny"):
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(
            get_config(arch).reduced(n_layers=1, max_d_model=128),
            attn_impl=impl)
        model = init_params(cfg, seed=0, device="cpu")
        st = init_opt_state(trainable(model), oc)
        b = batch_tensors(batch_for(cfg, 2, 8), cfg, "cpu")
        model, st, m = make_train_step(cfg, oc)(model, st, b)
        assert m["loss"].isfinite() and int(st.step) == 1
        print("trained", arch, impl, float(m["loss"]))
checkpoint.save(sys.argv[1], {"s": st})
assert int(checkpoint.restore(sys.argv[1], device="cpu")["s"].step) == 1
out = run_scheduled_training(
    "hadare", archs=["llama3.2-1b"], target_steps=4, base_steps_per_round=2,
    nodes=[EmuNode("a", "rtx3090", 1.0), EmuNode("b", "t4", 0.5)],
    verbose=False, device="cpu", attn_impl="pallas")
assert out["cru"] == 1.0, out
print("scheduled training", out["rounds"], out["eval_losses"])
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_trains_with_jax_and_repro_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", TRAIN_WITHOUT_JAX,
                          str(tmp_path / "ck.npz")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for arch in ("llama3.2-1b", "rwkv6-7b", "hymba-1.5b", "whisper-tiny"):
        assert f"trained {arch} pallas" in res.stdout
    assert "scheduled training" in res.stdout

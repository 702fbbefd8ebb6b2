"""The port stands alone: no ``jax`` and no ``repro`` import, anywhere in
``src/repro_torch``, ``chip_smoke.py``, ``chip_mutants.py`` or
``chip_compare.py``, and it
serves, schedules and simulates under faults, HadarE included, with both
blocked."""
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
              REPO / "chip_compare.py"]
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"src/repro_torch/models/rwkv.py",
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
            "src/repro_torch/sim/adapters.py"} <= names
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
from repro_torch.models import convert, rwkv
from repro_torch.models.model import init_params
from repro_torch.serve.serve_step import Request, ServingEngine
for arch in ("llama3.2-1b", "rwkv6-7b"):
    cfg = get_config(arch).reduced(n_layers=1, max_d_model=128)
    model = init_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(cfg, model, slots=1, max_seq=8, device="cpu")
    (r,) = eng.run([Request(0, np.arange(3), 2)])
    assert len(r.out) == 2
    print("served", arch, r.out.tolist())
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
    assert "scheduled" in res.stdout
    assert "events" in res.stdout
    assert "hadare" in res.stdout

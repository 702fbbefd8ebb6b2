"""End-to-end scheduled training driver: the Hadar/HadarE scheduler drives
real training jobs on an emulated heterogeneous cluster.

The counterpart of ``repro.launch.train``.  Each cluster node has a speed
factor (its "GPU type"); a scheduling round gives every allocated job a
step budget proportional to its node's speed, the physical-cluster
semantics of paper §VI on one host.  HadarE forks each job into copies;
at every round boundary the Job Tracker aggregates step counts and
consolidates the copies' parameters by steps-weighted averaging
(``repro_torch.train.consolidate.weight_average``), the §V-B procedure,
and averages their optimizer states the same way (which makes the
optimizer's step count fractional, as in the JAX package).  The jobs
train on ``device`` (default: the card; it raises without CUDA unless
given ``"cpu"``), through the kernels when ``attn_impl="pallas"``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --scheduler hadare \
      [--steps 48] [--rounds 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.throughput import ThroughputTracker
from repro_torch.data.pipeline import SyntheticLM, data_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import batch_tensors, init_params
from repro_torch.train._tree import tree_map
from repro_torch.train.consolidate import weight_average
from repro_torch.train.optimizer import OptConfig, OptState, init_opt_state
from repro_torch.train.train_step import (load_params, make_eval_step,
                                          make_train_step, trainable)


@dataclasses.dataclass
class EmuNode:
    name: str
    device: str          # throughput-table key (e.g. "v100", "tpu-v5e")
    speed: float         # relative steps per round


DEFAULT_NODES = [
    EmuNode("n0-rtx3090", "rtx3090", 1.00),
    EmuNode("n1-titanrtx", "titanrtx", 0.90),
    EmuNode("n2-t4", "t4", 0.45),
    EmuNode("n3-a2000", "a2000", 0.40),
    EmuNode("n4-t400", "t400", 0.15),
]


def _params(model) -> Dict:
    """A copy of ``model``'s parameters, name -> tensor."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


class RealJob:
    """A tiny-but-real training job: ``arch`` at ``reduced(max_d_model=
    128)``, float32, its weights from ``seed``.  ``params`` (name ->
    tensor) and ``opt_state`` are the job's consolidated state; the copies
    train one after another in one working model.  ``attn_impl`` None keeps
    the config's value."""

    def __init__(self, jid: int, arch: str, target_steps: int,
                 seed: int = 0, seq_len: int = 64, batch: int = 4,
                 device: DeviceLike = None, attn_impl: Optional[str] = None):
        self.jid = jid
        self.arch = arch
        self.device = resolve_device(device)
        cfg = get_config(arch).reduced(max_d_model=128)
        if attn_impl is not None:
            cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
        self.cfg = cfg
        self.target_steps = target_steps
        oc = OptConfig(lr=8e-3, warmup_steps=5, total_steps=target_steps * 2)
        self.oc = oc
        self.model = init_params(cfg, seed, device=self.device)
        trainable(self.model)
        self.params = _params(self.model)
        self.opt_state = init_opt_state(self.params, oc)
        self.step_fn = make_train_step(cfg, oc)
        self.eval_fn = make_eval_step(cfg)
        self.data = SyntheticLM(data_config(cfg, batch, seq_len, seed))
        self.eval_batch = batch_tensors(next(self.data.batches(start=10_000)),
                                        cfg, self.device)
        self.done_steps = 0
        self.finish_round: Optional[int] = None
        self.losses: List[float] = []

    def run_steps(self, params, opt_state, n: int, start_step: int):
        """``n`` steps from ``params``/``opt_state`` on the batches from
        ``start_step`` on.  Returns (params, opt_state, last loss); each
        step's loss is read on the host, one sync a step, so a copy's wall
        time is that of its steps and not of their launches."""
        load_params(self.model, params)
        it = self.data.batches(start=start_step)
        last = None
        for _ in range(n):
            b = batch_tensors(next(it), self.cfg, self.device)
            _, opt_state, m = self.step_fn(self.model, opt_state, b)
            last = float(m["loss"])
        return _params(self.model), opt_state, last

    def eval_loss(self, params=None) -> float:
        load_params(self.model, self.params if params is None else params)
        return float(self.eval_fn(self.model, self.eval_batch)["loss"])


def average_opt_states(states: List[OptState], steps: List[int]) -> OptState:
    """The Job Tracker's steps-weighted average of the copies' optimizer
    states (``repro/launch/train.py:197-200``): every leaf, ``step``
    included, which becomes a fractional float32."""
    return tree_map(lambda *xs: sum(x * (s / sum(steps))
                                    for x, s in zip(xs, steps)), *states)


def _allocate(scheduler: str, jobs: List[RealJob], nodes: List[EmuNode],
              tracker: ThroughputTracker, rr_state: Dict) -> Dict[int, List[int]]:
    """One round of node assignment: job id -> node indices.
    hadar/gavel: one node per job.  hadare: every live job may take several
    nodes (fork copies).  gavel is round-robin over its per-job best type
    (job-level); hadar picks by estimated throughput (task-level greedy);
    hadare = hadar + forking to fill idle nodes."""
    live = [j for j in jobs if j.done_steps < j.target_steps]
    if not live:
        return {}
    order = sorted(live, key=lambda j: -(j.target_steps - j.done_steps))
    free = list(range(len(nodes)))
    alloc: Dict[int, List[int]] = {}
    if scheduler in ("hadar", "hadare"):
        for j in order:
            if not free:
                break
            best = max(free,
                       key=lambda ni: tracker.get(j.arch, nodes[ni].device))
            alloc[j.jid] = [best]
            free.remove(best)
        if scheduler == "hadare":
            k = 0
            while free:
                j = order[k % len(order)]
                best = max(free,
                           key=lambda ni: tracker.get(j.arch,
                                                      nodes[ni].device))
                alloc[j.jid].append(best)
                free.remove(best)
                k += 1
    else:  # gavel: job-level, round-robin single node per job, no forking
        start = rr_state.get("rr", 0)
        for i, j in enumerate(order):
            if not free:
                break
            ni = free[(start + i) % len(free)]
            alloc[j.jid] = [ni]
            free.remove(ni)
        rr_state["rr"] = start + 1
    return alloc


def run_scheduled_training(scheduler: str = "hadare",
                           archs: Optional[List[str]] = None,
                           target_steps: int = 48,
                           base_steps_per_round: int = 8,
                           max_rounds: int = 200,
                           seed: int = 0,
                           nodes: Optional[List[EmuNode]] = None,
                           verbose: bool = True,
                           device: DeviceLike = None,
                           attn_impl: Optional[str] = None) -> Dict:
    nodes = nodes or DEFAULT_NODES
    archs = archs or ["llama3.2-1b", "rwkv6-7b", "qwen3-moe-235b-a22b"]
    jobs = [RealJob(i, a, target_steps, seed=seed + i, device=device,
                    attn_impl=attn_impl)
            for i, a in enumerate(archs)]
    tracker = ThroughputTracker([j.arch for j in jobs],
                                [n.device for n in nodes])
    rr_state: Dict = {}
    busy_node_rounds = 0
    total_node_rounds = 0
    t0 = time.time()
    rnd = 0
    for rnd in range(max_rounds):
        if all(j.done_steps >= j.target_steps for j in jobs):
            break
        alloc = _allocate(scheduler, jobs, nodes, tracker, rr_state)
        total_node_rounds += len(nodes)
        busy_node_rounds += sum(len(v) for v in alloc.values())
        for j in jobs:
            nids = alloc.get(j.jid)
            if not nids:
                continue
            remaining = j.target_steps - j.done_steps
            # per-copy quotas proportional to node speed (paper §V-B)
            speeds = np.array([nodes[ni].speed for ni in nids])
            budget = min(remaining,
                         int(round(base_steps_per_round * speeds.sum())))
            if budget <= 0:
                continue
            quotas = np.maximum(1, np.round(
                budget * speeds / speeds.sum()).astype(int))
            while quotas.sum() > budget:
                quotas[np.argmax(quotas)] -= 1
            results = []
            for ni, q in zip(nids, quotas):
                if q <= 0:
                    continue
                wall = time.time()
                p, o, loss = j.run_steps(j.params, j.opt_state, int(q),
                                         start_step=j.done_steps * 7 + ni)
                dur = max(time.time() - wall, 1e-6)
                tracker.observe(j.arch, nodes[ni].device, q / dur)
                results.append((p, o, int(q), loss))
            if not results:
                continue
            if len(results) == 1:
                j.params, j.opt_state, _, loss = results[0]
                got = results[0][2]
            else:
                # Job-Tracker consolidation: steps-weighted averaging
                steps = [r[2] for r in results]
                j.params = weight_average([r[0] for r in results], steps)
                j.opt_state = average_opt_states([r[1] for r in results],
                                                 steps)
                got = sum(steps)
                loss = float(np.mean([r[3] for r in results
                                      if r[3] is not None]))
            j.done_steps += got
            j.losses.append(loss)
            if j.done_steps >= j.target_steps and j.finish_round is None:
                j.finish_round = rnd
        if verbose:
            prog = " ".join(f"{j.arch[:12]}:{j.done_steps}/{j.target_steps}"
                            for j in jobs)
            print(f"[{scheduler}] round {rnd}: {prog}")
    return {
        "scheduler": scheduler,
        "rounds": rnd,
        "wall_seconds": time.time() - t0,
        "cru": busy_node_rounds / max(1, total_node_rounds),
        "mean_finish_round": float(np.mean(
            [j.finish_round if j.finish_round is not None else rnd
             for j in jobs])),
        "eval_losses": {j.arch: j.eval_loss() for j in jobs},
        "throughput_coverage": tracker.coverage(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default="hadare",
                    choices=["hadar", "hadare", "gavel"])
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without it) or cpu")
    args = ap.parse_args(argv)
    out = run_scheduled_training(args.scheduler, target_steps=args.steps,
                                 max_rounds=args.rounds, device=args.device)
    print(out)


if __name__ == "__main__":
    main()

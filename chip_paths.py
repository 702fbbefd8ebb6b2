#!/usr/bin/env python3
"""The model code of several checkouts side by side on one card:
llama3.2-1b's kernel-path prefill, its serving and its train step, each
checkout in a process of its own, through that checkout's own
``chip_smoke`` phases (``phase_prefill``, ``phase_serve``,
``phase_train``), so each is measured as its own smoke measures it.

    python3 chip_paths.py --tree base=DIR [--tree NAME=DIR ...]
                          [--rounds 2] [--out FILE.json]

"this" is the checkout the script lies in; each ``--tree`` is another
(the parent commit unpacked with ``git archive``).  Round r runs the
checkouts in order, reversed every other round (base, this, this, base
for two), so a drift of the host or the card over the call falls on both
sides.  A process builds its checkout's four kernels of that path (K1,
K3, K1b, K3b) in its own ``_build`` directory first.  Prints the card's
name and power limit, then one JSON line per run: first the model's own
calls (the checkout's ``forward`` and ``make_serve_step``), the medians
of ``REPS`` kernel-path forwards on 4 x 1024 tokens by CUDA events and
by the host's clock and of ``STEPS`` decode steps of 4 sequences (host-
bound: where host work added to the plain path shows first); then the
smoke phases' figures: the prefill's kernel-path tok/s and wall (median
of five), the serving tok/s (one host-clock sample), the train step's ms
(median of the last five of 8) and its forward / backward / optimizer
split.  Exits non-zero if a run fails.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "llama3.2-1b"
KERNELS = ["flash_attention", "rmsnorm", "flash_attention_bwd",
           "rmsnorm_bwd"]
# warm-up calls, timed forwards (4 x 1024 tokens) and timed decode steps
# (4 sequences)
WARM, REPS, STEPS = 3, 30, 64
RUN = """
import dataclasses, json, statistics, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.models.cache import init_cache
from repro_torch.models.model import forward, init_params
from repro_torch.serve.serve_step import make_serve_step
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all({kernels!r})
arch = {arch!r}

# the model's own calls, many times: the forward by CUDA events and the
# host's clock, a decode step (host-bound) by the host's clock
cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")
model = init_params(cfg, 0, device="cuda")
g = torch.Generator(device="cuda").manual_seed(1)
tokens = torch.randint(0, cfg.vocab_size, (4, 1024), device="cuda",
                       generator=g)
ev, host = [], []
with torch.no_grad():
    for i in range({warm} + {reps}):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        forward(model, cfg, {{"tokens": tokens}})
        b.record()
        torch.cuda.synchronize()
        if i >= {warm}:
            host.append((time.perf_counter() - t0) * 1e3)
            ev.append(a.elapsed_time(b))
    cache = init_cache(cfg, 4, {steps} + {warm}, device="cuda")
    step = make_serve_step(cfg)
    tok, dec = tokens[:, 0], []
    for pos in range({warm} + {steps}):
        t0 = time.perf_counter()
        tok, cache, _ = step(model, cache, tok, pos)
        torch.cuda.synchronize()
        if pos >= {warm}:
            dec.append((time.perf_counter() - t0) * 1e3)
direct = {{"forward_ms_events": statistics.median(ev),
          "forward_ms_host": statistics.median(host),
          "decode_step_ms_host": statistics.median(dec)}}
del model, cache
torch.cuda.empty_cache()
p = cs.phase_prefill(0, arch)
s = cs.phase_serve(0, arch)
t = cs.phase_train(0, arch)
print("RESULT " + json.dumps({{
    **direct,
    "prefill_tok_per_s": p["bf16_pallas_tok_per_s"],
    "prefill_wall_s": p["bf16_pallas_wall_s"],
    "serve_tok_per_s": s["tok_per_s"],
    "train_step_ms": t["step_ms"],
    "train_split": t["split"]}}), flush=True)
"""


def run_tree(name: str, tree: Path, arch: str, log_dir: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    log = log_dir / f"paths_{name}.log"
    with open(log, "a") as f:
        proc = subprocess.run(
            [sys.executable, "-c", RUN.format(
                kernels=KERNELS, arch=arch, warm=WARM, reps=REPS,
                steps=STEPS)],
            cwd=str(tree), env=env, stdout=subprocess.PIPE, stderr=f,
            text=True)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{name}: exit {proc.returncode}; see {log}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR, another checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_paths: CUDA is not available", file=sys.stderr)
        return 1
    trees = {}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    trees["this"] = ROOT
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    log_dir = ROOT / "chiprun_out"
    log_dir.mkdir(exist_ok=True)
    runs = []
    order = list(trees)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            res = {"tree": name, "round": r,
                   **run_tree(name, trees[name], ARCH, log_dir)}
            print(json.dumps(res), flush=True)
            runs.append(res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "arch": ARCH, "runs": runs}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

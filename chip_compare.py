#!/usr/bin/env python3
"""Side-by-side timing of K2-K5 built from several checkouts, on one
card.

    python3 chip_compare.py [--tree NAME=DIR ...] [--kernels rmsnorm,rwkv6_scan]
                            [--rounds N] [--out FILE.json]
    python3 chip_compare.py --tree base=DIR --kernels commit_scan
    python3 chip_compare.py --tree base=DIR --kernels find_alloc

Builds each named kernel (``src/repro_torch/kernels/csrc/<k>.cu``) from
this checkout ("this") and from each ``--tree`` (another checkout: the
parent commit unpacked with ``git archive``, or a copy with one constant
changed) through ``chip_mutants.build``, one ``nvcc`` each, all at once.
Each build is checked with the smoke's gates on the main-path shapes of
``chip_smoke.py`` (K3: 4096 x 2048 and 4096 x 4096 bf16; K2: B=4 H=64
S=1024 D=64, bf16 r/k/v in model layout, f32 w; K5: the fig5 n=2048 grown
and bursty tables, ``chip_smoke.commit_scan_check``: bitwise, twice; K4:
the fig5 n=2048 grown and bursty tables, the n=256 "busy" and n=8192
"queue" ones of ``chip_smoke.k4_tables``, ``chip_smoke.find_alloc_check``:
bitwise, twice; and every launch of the smoke's 256-job ``simulate`` and
of its faulted event run, recorded with its inputs, each bitwise against
its plain version), then
timed through ``chip_mutants.swapped``, the builds in turn, forwards then
backwards, ``--rounds`` times:

- "cold": on the card alone (``chip_smoke.device_ms``), K3's x and K5's
  tables cycled through copies past L2 (``chip_smoke.cold_copies``), as
  the smoke's ``ms``; K4's tables and its 11 outputs too (each launch
  reads and writes its own copies);
- "warm" (K3): back to back on one x, once on each of those copies: how
  much of x the L2 keeps between calls depends on where x lies, so one
  allocation is not a reading;
- "forward": the mean device time of the kernel's launches inside a
  kernel-path ``forward`` at full width, depth cut (``FORWARDS``), on
  4 x 1024 tokens, from ``torch.profiler``'s trace of the card (x of
  every norm has just been written by the layer before); "forward all":
  the device time of all the forward's work, which also sees what the
  kernel leaves in L2 for the next one.

For K3, ``F.rms_norm`` takes its cold and warm turns beside the builds (a
yardstick only).  K4 and K5 have no forward.  K4 has two more modes:
"outputs to host", the host-clock time of copying one launch's 11
outputs to host NumPy arrays as ``batch_solver.find_alloc_batch`` does;
and, on the "simulate" and "events" cases, "launches", the total device
time of that run's launches back to back, each on its own recorded
tables.  Every build's ``ptxas`` lines (registers, spills) are printed
first.  Reports every time and each median; exits non-zero if a build
fails a gate.  Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import tempfile
from pathlib import Path

import chip_mutants
import chip_smoke

ROOT = Path(__file__).resolve().parent
CSRC = Path("src/repro_torch/kernels/csrc")
# kernel -> its standalone main-path cases
CASES = {"rmsnorm": [(4096, 2048, "bfloat16", "bfloat16", "main", 50),
                     (4096, 4096, "bfloat16", "bfloat16", "rwkv", 50)],
         "rwkv6_scan": [chip_smoke.RWKV_MAIN + ("bfloat16", "main", 20)],
         "commit_scan": [(2048, "grown", 10), (2048, "bursty", 10)],
         "find_alloc": [(2048, "grown", 20), (2048, "bursty", 20),
                        (256, "busy", 20), (8192, "queue", 10),
                        (chip_smoke.SIM_JOBS, "simulate", 0),
                        (chip_smoke.SIM_JOBS, "events", 0)]}
# kernel -> (a part of its CUDA kernels' names, [(model, layers)]): the
# forwards it is timed in
FORWARDS = {"rmsnorm": ("rmsnorm", [("llama3.2-1b", 4), ("rwkv6-7b", 2)]),
            "rwkv6_scan": ("wkv6", [("rwkv6-7b", 2)])}


def forward_call(arch: str, layers: int, seed: int = 0):
    """One call of the kernel-path ``forward`` of ``arch`` at full width
    and ``layers`` layers on 4 x 1024 tokens, bf16."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import forward, init_params
    base = dataclasses.replace(get_config(arch), n_layers=layers)
    cfg = dataclasses.replace(base, attn_impl="pallas")
    model = init_params(base, seed, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    tokens = torch.randint(0, base.vocab_size, (4, 1024), generator=gen,
                           device="cuda")
    return lambda: forward(model, cfg, {"tokens": tokens})


def in_forward_ms(call, name: str, reps: int = 3) -> tuple:
    """From the profiler's trace of the card over ``reps`` calls of
    ``call``: the device time (ms) of every launch of a CUDA kernel whose
    name holds ``name``, and the device time of all of a call's work."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = [e.time_range.elapsed_us() / 1e3 for e in dev if name in e.name]
    if not ms:
        raise RuntimeError(f"the profiler traced no kernel named *{name}*")
    return ms, sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps


def _commit_scan_case(case):
    """K5's check and cold timer on the fig5 tables of ``case``: every
    launch on its own copy of the inputs, copies cycled past L2."""
    from repro_torch.core.dp import COMM_COST_FRAC
    from repro_torch.kernels import commit_scan as ck
    n, topo, iters = case
    tab = chip_smoke.sched_tables(n, topo)[1]
    _, args, out, _, plain = chip_smoke.commit_scan_check(tab)
    kw = (tab["n_nodes"], COMM_COST_FRAC, tab["wmax"])
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *out))
    copies = zip(*(chip_smoke.cold_copies(t, nbytes) for t in args))
    calls = [lambda c=c, o=[t.clone() for t in out]: ck.launch(c, o, *kw)
             for c in copies]
    return (lambda: chip_smoke.commit_scan_check(tab, plain)[0],
            {"cold": lambda: [chip_smoke.device_ms(chip_smoke.cycled(calls),
                                                   iters)]}, {})


def _find_alloc_case(case):
    """K4's check and timers on the tables of ``case`` (fig5, or
    ``chip_smoke.k4_tables``): "cold", every launch on its own copy of the
    inputs and of the outputs, copies cycled past L2; "outputs to host",
    the host-clock time of copying one launch's outputs to host NumPy
    arrays.  The "simulate" and "events" cases are ``_find_alloc_path``."""
    import time
    import torch
    from repro_torch.core.dp import COMM_COST_FRAC
    from repro_torch.kernels import find_alloc as fk
    n, kind, iters = case
    if kind in PATH_RUNS:
        return _find_alloc_path(n, kind)
    tab = (chip_smoke.k4_tables(kind, n) if kind in dict(chip_smoke.EXTRA_K4)
           else chip_smoke.sched_tables(n, kind)[0])
    _, args, out = chip_smoke.find_alloc_check(tab)
    kw = (tab["n_nodes"], COMM_COST_FRAC, tab["wmax"])
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *out))
    ins = list(zip(*(chip_smoke.cold_copies(t, nbytes) for t in args)))
    outs = list(zip(*(chip_smoke.cold_copies(t, nbytes) for t in out)))
    calls = [lambda c=c, o=o: fk.launch(c, o, *kw) for c, o in zip(ins, outs)]

    def to_host():
        fk.launch(args, out, *kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        [t.cpu().numpy() for t in out]
        return [(time.perf_counter() - t0) * 1e3]
    return (lambda: chip_smoke.find_alloc_check(tab)[0],
            {"cold": lambda: [chip_smoke.device_ms(chip_smoke.cycled(calls),
                                                   iters)],
             "outputs to host": to_host}, {})


def _simulate_run(jobs, cluster):
    from repro_torch.core.hadar import HadarScheduler
    from repro_torch.core.simulator import simulate
    simulate(HadarScheduler(solver="cuda"), jobs, cluster)


def _events_run(jobs, cluster):
    from repro_torch.core.hadar import HadarScheduler
    from repro_torch.sim.engine import simulate_events
    from repro_torch.sim.faults import FailureModel
    simulate_events(HadarScheduler(solver="cuda"), jobs, cluster,
                    faults=FailureModel(**chip_smoke.FAULT_MODEL))


# K4's recorded paths: the smoke's 256-job ``simulate``
# (``chip_smoke.phase_simulate``) and its faulted event run
# (``chip_smoke.phase_events``), cuda solver
PATH_RUNS = {"simulate": _simulate_run, "events": _events_run}


def _find_alloc_path(n: int, kind: str):
    """K4's launches in one of the smoke's runs of the ``n``-job fig5
    trace (``PATH_RUNS``), each recorded with its inputs.  The check runs
    each recorded launch once against its plain version, bitwise; the
    timer, "launches", runs all of them back to back on the card
    (``device_ms``), each on its own tables, and returns their total
    device time in ms."""
    from collections import Counter
    from unittest import mock
    import torch
    from repro_torch.core.types import clone_jobs
    from repro_torch.kernels import find_alloc as fk
    from repro_torch.kernels import ref
    real, seen = fk.launch, []

    def record(ins, out, *kw):
        seen.append(([t.clone() for t in ins], kw))
        real(ins, out, *kw)
    jobs, cluster, _ = chip_smoke.fig5_round(n, "grown")
    with mock.patch.object(fk, "launch", record):
        PATH_RUNS[kind](clone_jobs(jobs), cluster)
    plain = [ref.find_alloc_ref(*ins, *kw) for ins, kw in seen]
    outs = [fk.find_alloc(*ins, *kw) for ins, kw in seen]  # the layout
    calls = [lambda ins=ins, o=o, kw=kw: fk.launch(ins, o, *kw)
             for (ins, kw), o in zip(seen, outs)]
    sizes = dict(sorted(Counter(ins[6].shape[0] for ins, _ in seen).items()))

    def check():
        for o in outs:  # a field the build leaves unwritten then differs
            for t in o:
                t.view(torch.uint8).fill_(0xA5)
        for call in calls:
            call()
        torch.cuda.synchronize()
        bad = sum(not chip_smoke._same_bits(o, p)
                  for o, p in zip(outs, plain))
        return {"launches": len(calls), "jobs a launch": sizes,
                "mismatched launches": bad, "ok": bad == 0}
    total = len(calls)
    return check, {"launches": lambda: [chip_smoke.device_ms(
        chip_smoke.cycled(calls), total) * total]}, {}


def _ptxas(log: str) -> list:
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]


def _case(kernel: str, case, gen):
    """(check(): one call's errors by the smoke's gates, {mode: timer},
    {mode: library timer}); a timer returns a list of ms."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import rwkv6_scan as rk
    dev_ms = chip_smoke.device_ms
    iters = case[-1]
    if kernel == "commit_scan":
        return _commit_scan_case(case)
    if kernel == "find_alloc":
        return _find_alloc_case(case)
    if kernel == "rwkv6_scan":
        args = chip_smoke.rwkv_inputs(case, gen)
        want, want_s = ref.rwkv6_scan_ref(*args)
        torch.cuda.synchronize()

        def check():
            out, s = rk.rwkv6_scan(*args)
            return chip_smoke.state_gate(
                chip_smoke.gate(out, want, case[4]), s, want_s)
        return check, {"cold": lambda: [dev_ms(lambda: rk.rwkv6_scan(*args),
                                               iters)]}, {}
    x, scale = chip_smoke.rms_inputs(case, gen)
    want = ref.rmsnorm_ref(x, scale, 1e-5)

    def check():
        err = chip_smoke.row_rel_err(rms.rmsnorm(x, scale, 1e-5), want)
        return {"max_rel_err": err, "ok": err <= chip_smoke.RMS_BF16_ULP}
    xs = chip_smoke.cold_copies(x, 2 * x.numel() * x.element_size())
    calls = [lambda c=c: rms.rmsnorm(c, scale, 1e-5) for c in xs]
    lib = [chip_smoke.rms_library(c, scale) for c in xs]
    return check, {
        "cold": lambda: [dev_ms(chip_smoke.cycled(calls), iters)],
        "warm": lambda: [dev_ms(f, iters) for f in calls],
    }, {
        "cold": lambda: [dev_ms(chip_smoke.cycled(lib), iters)],
        "warm": lambda: [dev_ms(f, iters) for f in lib],
    }


def _timed(names: list, libs: dict, kernel: str, runs: dict,
           lib_runs: dict, rounds: int) -> dict:
    """(build or "library", mode) -> every ms, the builds in turn."""
    times = {(n, m): [] for n in names for m in runs}
    times.update({("library", m): [] for m in lib_runs})
    order = list(times)
    for rnd in range(rounds):
        for n, m in (order if rnd % 2 == 0 else order[::-1]):
            if n == "library":
                times[(n, m)] += lib_runs[m]()
                continue
            with chip_mutants.swapped(kernel, libs[f"{kernel}-{n}"]):
                times[(n, m)] += runs[m]()
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: build the kernels from another checkout")
    ap.add_argument("--kernels", default="rmsnorm,rwkv6_scan")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: CUDA is not available", file=sys.stderr)
        return 1
    trees = {"this": ROOT}
    for spec in args.tree:
        name, path = spec.split("=", 1)
        trees[name] = Path(path).resolve()
    kernels = args.kernels.split(",")
    report = {"card": chip_smoke.card_line(), "torch": torch.__version__,
              "kernels": {}}
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = chip_mutants.build(
            {f"{k}-{n}": ((t / CSRC / f"{k}.cu").read_text(), t / CSRC)
             for k in kernels for n, t in trees.items()}, Path(tmp))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        report["ptxas"] = {
            name: _ptxas((Path(tmp) / f"{name}.log").read_text())
            for name in libs}
        for name, lines in report["ptxas"].items():
            print(f"[compare] ptxas {name}: {lines}", flush=True)
        for kernel in kernels:
            rows = {}
            for case in CASES[kernel]:
                check, runs, lib_runs = _case(kernel, case, gen)
                checks = {}
                for n in trees:
                    with chip_mutants.swapped(kernel, libs[f"{kernel}-{n}"]):
                        checks[n] = check()
                    if not checks[n]["ok"]:
                        bad.append(f"{kernel}/{n}/{case[:5]}")
                times = _timed(list(trees), libs, kernel, runs, lib_runs,
                               args.rounds)
                rows[str(list(case[:5]))] = {
                    f"{n} {m}": {"ms": t, "median_ms": statistics.median(t),
                                 **checks.get(n, {})}
                    for (n, m), t in times.items()}
            part, models = FORWARDS.get(kernel, (None, []))
            for arch, layers in models:
                call = forward_call(arch, layers)
                times = _timed(list(trees), libs, kernel, {
                    "forward": lambda: [statistics.mean(
                        in_forward_ms(call, part)[0])],
                    "forward all": lambda: [in_forward_ms(call, part)[1]],
                }, {}, args.rounds)
                rows[f"{arch} forward, {layers} layers"] = {
                    f"{n} {m}": {"ms": t, "median_ms": statistics.median(t)}
                    for (n, m), t in times.items()}
                del call
                torch.cuda.empty_cache()
            for key, row in rows.items():
                print(f"[compare] {kernel} {key}: " + ", ".join(
                    f"{n} {r['median_ms']:.5f} ({min(r['ms']):.5f}-"
                    f"{max(r['ms']):.5f})" for n, r in row.items()),
                    flush=True)
            report["kernels"][kernel] = rows
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    print(report["card"])
    if bad:
        print(f"chip_compare: over a gate: {bad}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "medians": {
        f"{k} {key}": {n: r["median_ms"] for n, r in row.items()}
        for k, rows in report["kernels"].items()
        for key, row in rows.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Side-by-side timing of K2 and K3 built from several checkouts, on one card.

    python3 chip_compare.py [--tree NAME=DIR ...] [--kernels rmsnorm,rwkv6_scan]
                            [--rounds N] [--out FILE.json]

Builds each named kernel (``src/repro_torch/kernels/csrc/<k>.cu``) from
this checkout ("this") and from each ``--tree`` (another checkout: the
parent commit unpacked with ``git archive``, or a copy with one constant
changed) through ``chip_mutants.build``, one ``nvcc`` each, all at once.
Each build is checked with the smoke's gates on the main-path shapes of
``chip_smoke.py`` (K3: 4096 x 2048 and 4096 x 4096 bf16; K2: B=4 H=64
S=1024 D=64, bf16 r/k/v in model layout, f32 w), then timed through
``chip_mutants.swapped``, the builds in turn, forwards then backwards,
``--rounds`` times:

- "cold": on the card alone (``chip_smoke.device_ms``), K3's x cycled
  through copies past L2 (``chip_smoke.cold_copies``), as the smoke's
  ``ms``;
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
yardstick only).  Reports every time and each median; exits non-zero if a
build fails a gate.  Needs a card.
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
         "rwkv6_scan": [chip_smoke.RWKV_MAIN + ("bfloat16", "main", 20)]}
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


def _case(kernel: str, case, gen):
    """(check(): one call's errors by the smoke's gates, {mode: timer},
    {mode: library timer}); a timer returns a list of ms."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import rwkv6_scan as rk
    dev_ms = chip_smoke.device_ms
    iters = case[-1]
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
            part, models = FORWARDS[kernel]
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

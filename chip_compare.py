#!/usr/bin/env python3
"""Side-by-side timing of K1b-K5 built from several checkouts, on one
card.

    python3 chip_compare.py [--tree NAME=DIR ...] [--kernels rmsnorm,rwkv6_scan]
                            [--rounds N] [--out FILE.json]
    python3 chip_compare.py --tree base=DIR --kernels commit_scan
    python3 chip_compare.py --tree base=DIR --kernels find_alloc
    python3 chip_compare.py --tree base=DIR --kernels flash_attention_bwd
    python3 chip_compare.py --tree base=DIR --kernels rmsnorm_bwd,rwkv6_scan_bwd

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
of its faulted 128-job event run, recorded with its inputs, each bitwise against
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

The backward kernels (K1b ``flash_attention_bwd``, K2b ``rwkv6_scan_bwd``,
K3b ``rmsnorm_bwd``): each build runs through its own tree's binding
module (``tree_wrapper``: a tree's C entry may take other arguments).  K1b
is checked by ``chip_smoke.k1b_check`` (dq, dk, dv gated, twice and
bitwise) and timed at the llama3.2-1b train shape (model layout) and at
every ``chip_smoke.MODEL_ATTENTION`` shape; K2b by
``chip_smoke.k2b_check_case`` at the rwkv6-7b train shape (B=4 H=64
S=1024 D=64 bf16, model layout); K3b by ``chip_smoke.k3b_check`` at
4096 x 2048 and 4096 x 4096 bf16.  "cold": on the card alone
(``device_ms``), K1b's q, k, v, dO and K3b's x and dy cycled through
copies past L2 (K2b's inputs are 7x the L2), beside one PyTorch call for
the same gradient where there is one (SDPA's backward, ``F.rms_norm``'s
backward; a yardstick only).  "train step": the mean device time of one
call (its CUDA kernels summed) over a kernel-path train step's backward
on 4 x 1024 tokens (``torch.profiler``): llama3.2-1b at full depth for
K1b and K3b, rwkv6-7b at the smoke's 8 layers for K2b; for K1b also its
part in each of its three passes ("train step pass 0-2"); "backward
all", the device time of that whole backward.

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
import ctypes
import dataclasses
import importlib.util
import json
import statistics
import sys
import tempfile
from pathlib import Path
from unittest import mock

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
                        (chip_smoke.EVENT_JOBS, "events", 0)],
         "flash_attention_bwd": [chip_smoke.LLAMA_PREFILL + (True, 5)] + [
             (4, Hq, Hkv, S, D, "bfloat16", True, w, True, 3)
             for Hq, Hkv, D, S, w in chip_smoke.MODEL_ATTENTION.values()],
         "rwkv6_scan_bwd": [chip_smoke.RWKV_MAIN + ("bfloat16", "main", 5)],
         "rmsnorm_bwd": [(4096, 2048, "bfloat16", "bfloat16", "main", 50),
                         (4096, 4096, "bfloat16", "bfloat16", "rwkv", 50)]}
# kernel -> (a part of its CUDA kernels' names, [(model, layers)]): the
# forwards it is timed in
FORWARDS = {"rmsnorm": ("rmsnorm", [("llama3.2-1b", 4), ("rwkv6-7b", 2)]),
            "rwkv6_scan": ("wkv6", [("rwkv6-7b", 2)])}
# kernel -> (parts of the names of its CUDA kernels in any build, [(arch,
# layers)]): the kernel-path train steps whose backward it is timed in
# (None: full depth; rwkv6-7b at the smoke's training depth)
BACKWARDS = {"flash_attention_bwd": (
    ("lse_delta_kernel", "dkdv_kernel", "dq_kernel", "q_pass", "kv_pass",
     "kv_sum"), [("llama3.2-1b", None)]),
    "rwkv6_scan_bwd": (("wkv6_bwd_kernel", "wkv6_ckpt_kernel", "du_kernel"),
                       [("rwkv6-7b", chip_smoke.TRAIN["rwkv6-7b"]["layers"])]),
    "rmsnorm_bwd": (("rmsnorm_bwd", "dscale_kernel"),
                    [("llama3.2-1b", None)])}


def k1b_pass(name: str) -> int:
    """Which of K1b's three passes a CUDA kernel of either form runs (the
    split's sum counts with pass 1)."""
    if "lse_delta_kernel" in name or ("q_pass" in name and "false" in name):
        return 0
    if "dq_kernel" in name or ("q_pass" in name and "true" in name):
        return 2
    return 1


def tree_wrapper(kernel: str, tree: Path, lib: Path):
    """The function ``kernel`` of ``tree``'s own binding module
    (``flash_attention_bwd``, ``rwkv6_scan_bwd`` or ``rmsnorm_bwd``) bound
    to the library at ``lib``: another tree's C entry may take other
    arguments, so its wrapper goes with it."""
    spec = importlib.util.spec_from_file_location(
        f"{kernel}_{len(_WRAPPERS)}",
        tree / f"src/repro_torch/kernels/{kernel}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look themselves up
    spec.loader.exec_module(mod)
    mod._fn = mod.bind(ctypes.CDLL(str(lib)))
    return getattr(mod, kernel)


def use(kernel: str, lib: Path, tree: Path):
    """A context in which the port launches ``kernel`` from the library
    at ``lib`` built from ``tree``."""
    if kernel not in BACKWARDS:
        return chip_mutants.swapped(kernel, lib)
    mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
    key = (kernel, str(tree), str(lib))
    if key not in _WRAPPERS:
        _WRAPPERS[key] = tree_wrapper(kernel, tree, lib)
    return mock.patch.object(mod, kernel, _WRAPPERS[key])


_WRAPPERS = {}  # (kernel, tree, library) -> its wrapper


def train_backward_call(arch: str, layers, kernel: str, seed: int = 0):
    """(one call of a kernel-path train step's backward of ``arch`` at
    full width and ``layers`` layers (None: full depth) on 4 x 1024
    tokens: the loss and ``autograd.grad`` of every trainable parameter,
    remat's recompute included; its calls of ``kernel``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.train.train_step import trainable
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = init_params(cfg, seed, device="cuda")
    batch = chip_smoke._train_batch(cfg, 1024, seed)
    ps = list(trainable(model).values())

    def call():
        loss, _ = loss_fn(model, cfg, batch)
        torch.autograd.grad(loss, ps)
    return call, chip_smoke.train_launches(cfg)[kernel]


def in_backward_ms(call, names, calls: int, reps: int = 2) -> tuple:
    """From the profiler's trace of the card over ``reps`` calls of
    ``call``: the mean device time (ms) of one call of a backward kernel
    (the summed time of every CUDA kernel whose name holds one of
    ``names``, over ``calls`` a call), the device time of all of a call's
    work, and the first's part in each of K1b's passes (``k1b_pass``)."""
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
    k1b = [e for e in dev if any(n in e.name for n in names)]
    if not k1b:
        raise RuntimeError(f"the profiler traced no kernel named {names}")
    per = 1e3 * reps * calls
    passes = [sum(e.time_range.elapsed_us() for e in k1b
                  if k1b_pass(e.name) == i) / per for i in range(3)]
    return (sum(passes),
            sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps, passes)


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
# (``chip_smoke.phase_simulate``) and its faulted 128-job event run
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


def _k1b_case(case, gen):
    """K1b's check (``chip_smoke.k1b_check``) and its cold timer on the
    inputs of ``case`` (``chip_smoke.k1b_inputs``), q, k, v and dO cycled
    through copies past L2; SDPA's backward on the same inputs beside
    it."""
    import torch
    from repro_torch.kernels import flash_attention_bwd as fab
    q, k, v, do = chip_smoke.k1b_inputs(case, gen)
    causal, window, iters = case[6], case[7], case[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, do))
    sets = list(zip(*(chip_smoke.cold_copies(t, nbytes)
                      for t in (q, k, v, do))))
    calls = [lambda s=s: fab.flash_attention_bwd(*s, causal, window)
             for s in sets]
    with torch.enable_grad():
        leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
        lib_out = chip_smoke.sdpa_call(*leaves, causal, window)()
    return (lambda: chip_smoke.k1b_check(q, k, v, do, causal, window),
            {"cold": lambda: [chip_smoke.device_ms(chip_smoke.cycled(calls),
                                                   iters)]},
            {"cold": lambda: [chip_smoke.device_ms(
                lambda: torch.autograd.grad(lib_out, leaves, do,
                                            retain_graph=True), iters)]})


def _k2b_case(case):
    """K2b's check (``chip_smoke.k2b_check_case``, the smoke's "main"
    case) and its cold timer on the inputs of ``case``
    (``chip_smoke.k2b_inputs``): r, k, v, w and dO move 7x the L2's bytes
    a call, so back-to-back calls read them from device memory."""
    import torch
    from repro_torch.kernels import rwkv6_scan_bwd as rkb
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    args = chip_smoke.k2b_inputs(case, gen)

    def check():
        errs, _ = chip_smoke.k2b_check_case(case[5], args)
        return errs
    return check, {"cold": lambda: [chip_smoke.device_ms(
        lambda: rkb.rwkv6_scan_bwd(*args), case[-1])]}, {}


def _k3b_case(case, gen):
    """K3b's check (``chip_smoke.k3b_check``) and its cold timer on the
    inputs of ``case`` (``chip_smoke.k3b_inputs``), x and dy cycled
    through copies past L2; ``F.rms_norm``'s backward on the same copies
    beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm_bwd as rmb
    x, scale, dy = chip_smoke.k3b_inputs(case, gen)
    rows, D, iters = case[0], case[1], case[-1]
    nbytes = 3 * rows * D * x.element_size()
    pairs = list(zip(chip_smoke.cold_copies(x, nbytes),
                     chip_smoke.cold_copies(dy, nbytes)))
    calls = [lambda a=a, b=b: rmb.rmsnorm_bwd(a, scale, b) for a, b in pairs]
    lib = []
    with torch.enable_grad():
        for a, b in pairs:
            leaves = [a.detach().requires_grad_(),
                      scale.detach().requires_grad_()]
            out = F.rms_norm(leaves[0], (D,), leaves[1], 1e-5)
            lib.append(lambda o=out, l=leaves, b=b: torch.autograd.grad(
                o, l, b, retain_graph=True))
    return (lambda: chip_smoke.k3b_check(x, scale, dy),
            {"cold": lambda: [chip_smoke.device_ms(chip_smoke.cycled(calls),
                                                   iters)]},
            {"cold": lambda: [chip_smoke.device_ms(chip_smoke.cycled(lib),
                                                   iters)]})


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
    if kernel == "flash_attention_bwd":
        return _k1b_case(case, gen)
    if kernel == "rwkv6_scan_bwd":
        return _k2b_case(case)
    if kernel == "rmsnorm_bwd":
        return _k3b_case(case, gen)
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


def _timed(trees: dict, libs: dict, kernel: str, runs: dict,
           lib_runs: dict, rounds: int) -> dict:
    """(build or "library", mode) -> every ms, the builds in turn."""
    times = {(n, m): [] for n in trees for m in runs}
    times.update({("library", m): [] for m in lib_runs})
    order = list(times)
    for rnd in range(rounds):
        for n, m in (order if rnd % 2 == 0 else order[::-1]):
            if n == "library":
                times[(n, m)] += lib_runs[m]()
                continue
            with use(kernel, libs[f"{kernel}-{n}"], trees[n]):
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
                for n, t in trees.items():
                    with use(kernel, libs[f"{kernel}-{n}"], t):
                        checks[n] = check()
                    if not checks[n]["ok"]:
                        bad.append(f"{kernel}/{n}/{case[:5]}")
                times = _timed(trees, libs, kernel, runs, lib_runs,
                               args.rounds)
                del runs, lib_runs
                torch.cuda.empty_cache()
                rows[str(list(case[:5]))] = {
                    f"{n} {m}": {"ms": t, "median_ms": statistics.median(t),
                                 **checks.get(n, {})}
                    for (n, m), t in times.items()}
            part, models = FORWARDS.get(kernel, (None, []))
            for arch, layers in models:
                call = forward_call(arch, layers)
                times = _timed(trees, libs, kernel, {
                    "forward": lambda: [statistics.mean(
                        in_forward_ms(call, part)[0])],
                    "forward all": lambda: [in_forward_ms(call, part)[1]],
                }, {}, args.rounds)
                rows[f"{arch} forward, {layers} layers"] = {
                    f"{n} {m}": {"ms": t, "median_ms": statistics.median(t)}
                    for (n, m), t in times.items()}
                del call
                torch.cuda.empty_cache()
            names, archs = BACKWARDS.get(kernel, ((), []))
            for arch, layers in archs:
                call, calls = train_backward_call(arch, layers, kernel)
                modes = {
                    "train step": lambda: [in_backward_ms(call, names,
                                                          calls)[0]],
                    "backward all": lambda: [in_backward_ms(call, names,
                                                            calls)[1]]}
                if kernel == "flash_attention_bwd":
                    modes.update({f"train step pass {i}": lambda i=i: [
                        in_backward_ms(call, names, calls)[2][i]]
                        for i in range(3)})
                times = _timed(trees, libs, kernel, modes, {}, args.rounds)
                depth = "" if layers is None else f" ({layers} layers)"
                rows[f"{arch}{depth} train step backward, {calls} "
                     f"{kernel} calls"] = {
                    f"{n} {m}": {"ms": t, "median_ms": statistics.median(t)}
                    for (n, m), t in times.items()}
                del call
                torch.cuda.empty_cache()
            for key, row in rows.items():
                print(f"[compare] {report['card']} | {kernel} {key}: "
                      + ", ".join(f"{n} {r['median_ms']:.5f} "
                                  f"({min(r['ms']):.5f}-{max(r['ms']):.5f})"
                                  for n, r in row.items()), flush=True)
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (an H100 is the target).

    python3 chip_smoke.py [--seed N] [--out FILE.json]

Builds every hand-written kernel from ``src/repro_torch/kernels/csrc`` and
drives the port's paths with random weights and traces from ``--seed``:
llama3.2-1b and rwkv6-7b at full width and depth (flash attention K1, the
WKV6 scan K2, RMSNorm K3) and the Hadar decision path on the fig5 shape
(FIND_ALLOC K4, the greedy commit K5), through the round and the event
engine and HadarE's forked copies, with and without faults.  Any failure raises and the script
exits non-zero.

1. kernel  -- each kernel against its plain PyTorch version
   (``kernels/ref.py``) on the card, then timed on the card alone
   (``device_ms``: the timed launches run back to back behind a spin
   kernel, so the host's launch rate is not timed); the plain versions
   are timed as they run, host included.  float32 outputs are held to a max
   abs error of 2e-4; bfloat16 outputs to a max abs error over each
   (batch, head, 64-row block) of 3e-2 of that block's largest output
   (``rowblock_rel_err``), so the limit follows the output's size along
   the sequence.
   K1: the shape sweep of the JAX package's kernel tests, the llama3.2-1b
   prefill shapes, ragged S=100 and S=1000, a window of 300 at S=2048
   (its lower edge inside a key tile) and D=128 at S=1024 (a row in two
   swizzle boxes); every case runs twice and the two outputs must be
   bitwise equal; timed beside ``scaled_dot_product_attention`` (a
   yardstick only; the port never calls it).
   K2: the sweep of the JAX package's rwkv6 tests in float32 and bfloat16,
   the rwkv6-7b prefill shape with random S_0, ragged S=1000, decays near
   1 (a long memory), two chained halves against one scan (1e-4), S=17,
   w = 0.01 over a whole chunk (its decay underflows) and D = 16 and 128.
   In the bfloat16 cases w stays float32, as the model passes it.  The
   final state is held to the JAX test's 5e-2 and to 1e-4 of its largest
   value.  Every case runs twice and the two results must be bitwise
   equal.  No PyTorch call computes WKV6.
   K3: the llama and rwkv6 prefill norms (4096 x 2048 and 4096 x 4096),
   a ragged 1000 x 1600, strided and unaligned row views, small rows
   where eps matters, float32 rows of 4096 and row counts that are not a
   multiple of a block's rows; float32 within 1e-5 (the JAX property
   test), bf16 within one bf16 ulp (2**-7) of each row's largest value;
   every case twice, bitwise equal; timed beside ``F.rms_norm`` (a
   yardstick only), both on x read from device memory (copies cycled
   past the L2 cache, as the byte bound assumes) and on one x back to
   back ("warm", x in L2).
   K4, K5: the host tables of the first K4 launch and of a K5 launch over
   the whole greedy order of the fig5 round (n = 256, 1024, 2048; grown
   cluster and bursty 3-pod topology): every result bitwise equal to the
   plain version's (K5's runner-up payoff within one ulp, reported).  K4 also
   runs on tables whose walks the fig5 round never makes (``k4_tables``):
   "busy", the fig5 grown state at n = 256 and 2048 with a seeded share
   of the units taken (walks several chunks deep, prefixes that end short
   of W); "wide", gangs of 16-128 (wmax 128) that choose units of the
   pool's partial last chunk; "mixed", a 5-type multi_cluster with mixed
   nodes, jobs that use a subset of the types, a fifth single-node,
   fractional free units and N not a multiple of 32; "queue", 8192 jobs,
   more than the card holds warps of K4 at once; "hadare", the first
   greedy consult of phase 10 (720 single-node copies, each parent's 15
   copies equal but for their ids, bucket 1024).  Every K4 case runs
   twice and must be bitwise deterministic; the log counts the walks past
   the first chunk and into a partial last one.  K5 also
   runs on the n=256 grown tables with a fractional carry (0.5 added to,
   and taken from, every third key's free: ``frac_tables``) and on two
   seeded tables with pools in random order (``random_tables``: walks that
   reach a partial last chunk or go 9 chunks deep; one with every window
   cut at the last unit) and on phase 10's first greedy consult
   ("hadare"); every K5 case runs twice and must be bitwise deterministic; its row gives the
   microseconds a step.  First the running NumPy is checked to sum float64
   in the order both replicate.
2. prefill -- llama3.2-1b ``forward`` on 4 x 1024 tokens in bf16,
   through the kernels (``attn_impl="pallas"``) and through the einsum
   path (``"xla"``), each timed as the median of ``FORWARD_REPS`` calls.
   The launch counts are set to 0 just before each timed forward and read
   just after: the kernel path must launch K1 16 times (one per layer)
   and K3 33 times (2 per layer + the final norm), the plain path
   nothing.  A third path, the kernels with the plain norm, times what K3
   saves.  At every layer K1 on that
   layer's own bf16 q, k, v is held against the plain version with the
   bf16 limit above.  The same weights drawn in float32: each layer's
   output through both paths within 2e-4 of its largest value, and top-1
   agreement >= 99% after one layer.
3. serve   -- llama3.2-1b ``ServingEngine`` (4 slots, max_seq 256) answers
   8 requests of 32-96 prompt tokens and 32 new tokens each; the decode
   path launches no kernel.
4. prefill_rwkv -- the same for rwkv6-7b (32 layers, d_model 4096, 64
   heads of 64, bf16): K2 must launch 32 times in the kernel run, K3 65
   times, K1 none; K2 on each layer's own r, k, v, w, u against the plain
   version; the float32 weights at depth 2 per layer and at depth 1 as
   above.
5. serve_rwkv -- rwkv6-7b ``ServingEngine`` as in 3; it decodes through
   the plain one-step scan and the plain norm, as the JAX package does, so
   no kernel launches.
6. schedule -- one ``HadarScheduler.schedule`` round of the fig5 shape
   (``philly_trace(n, seed=1)`` on ``grown_cluster(n)``, and bursty
   arrivals on the 3-pod ``multi_cluster``) for n = 64, 256, 1024, 2048,
   with ``solver="cuda"`` and ``solver="numpy"``: the decisions (job ->
   allocation, cost, payoff, rate) must be identical, the cuda round must
   launch K4 and K5 (n >= 256) and the numpy round nothing.  The seconds
   per round of both are the sweep that will calibrate ``auto``.
7. simulate -- ``simulate`` of the 256-job fig5 trace with both solvers,
   then the 48-job fig5 trace (``FAULT_ROUND_JOBS``) through
   ``simulate_rounds`` under a seeded ``FailureModel`` (``FAULT_MODEL``),
   each with both solvers: every result field but host time
   equal (average JCT, makespan, each finish time, evictions, lost
   GPU-seconds, each round record); K4 and K5 launched by the cuda runs
   only; the faulted run's rounds, evictions, average JCT and makespan
   those of the JAX package (``REF_ROUNDS_FAULTED``).
8. events -- ``simulate_events`` of the 256-job trace under the same model
   with both solvers: every result field but host time equal; K4 and K5
   launched by the cuda run only; events, consults and evictions those of
   the JAX package, its average JCT and makespan within 1e-9 relative
   (``REF_EVENTS``).  Reports each solver's wall and seconds a consult,
   K4's and K5's launches, K4's job buckets B and the ``PriceState``s
   built; the cuda run is traced by ``torch.profiler`` (device activity
   only) for the device time of K4, K5 and all the device's work, and
   its share of that run's wall.
9. mini -- ``examples/traces/philly_mini.csv`` on ``simulation_cluster()``
   through both engines and both solvers, under its fault CSV and under a
   hand-made trace that downs the five K80 nodes together, and a 48-job
   fig5 trace through the event engine with the K80s down from t=0: each
   cuda run equal to its numpy run and launching K4; under the outage K4,
   and on the 48-job trace K5, took tables with R = 2.
10. hadare -- HadarE (``repro_torch.sim.adapters.simulate_hadare``: every
   parent forked into one single-node copy per node) on the 48-job fig5
   trace (``HADARE_JOBS``, 15 nodes, queues of up to 720 copies) under
   ``FAULT_MODEL``, with both solvers: every result field but host time
   equal, each consult's decision keys in order equal before and after
   sibling dedupe, K4 and K5 launched by the cuda run only, the rounds
   and evictions those of the JAX package, its average JCT and makespan
   within 1e-9 relative (``REF_HADARE``); the cuda run traced as in 8.
   Then every mix on the paper's ``aws_cluster()`` and
   ``testbed_cluster()`` at 90 s a round, both solvers: equal results
   and keys, K4 launched by each cuda run.

Full-depth agreement of the two model paths is printed, not gated: the
random init makes a deep stack chaotic.  It prints a ``{"kernels":
[...]}`` line, the card's name and power limit, and last ``{"ok": true,
"device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (dense): bf16 tensor cores, f32 CUDA
# cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# float32: max abs error.  bfloat16: max abs error over each (batch, head,
# 64-row block) over that block's largest |output|; two bf16 ulps of the
# block's largest value are at most 2 * 2**-7 = 0.0156 of it.
F32_TOL = 2e-4
BF16_REL_TOL = 3e-2
ROW_BLOCK = 64
SWEEP = [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
         (2, 2, 2, 384, 32)]
MASKS = [(True, 0), (True, 96), (False, 0)]
# llama3.2-1b: 32 q heads, 8 kv heads, head dim 64, window 8192
LLAMA_PREFILL = (4, 32, 8, 1024, 64, "bfloat16", True, 8192)
# K2: the JAX package's rwkv6 sweep (tests/test_kernels.py) and the
# rwkv6-7b prefill shape (64 heads of 64, 4 x 1024 tokens)
RWKV_SWEEP = [(1, 2, 64, 16), (2, 2, 128, 32), (1, 1, 96, 64)]
RWKV_MAIN = (4, 64, 1024, 64)
STATE_TOL = 5e-2  # the JAX test's bound on the final state
# ... and over the largest |state|: kernel and plain version run the same
# sequential f32 recurrence, so they agree to ~1e-7 of it
STATE_REL_TOL = 1e-4
CHAIN_TOL = 1e-4
# K3: f32 max abs error (the JAX property test's tolerance); bf16 max over
# rows of the row's max abs error over its largest |output|, one bf16 ulp
# (2**-7 of a value's leading power of two).  The gate follows
# ``rowblock_rel_err`` with one-row blocks.
RMS_F32_TOL = 1e-5
RMS_BF16_ULP = 2.0 ** -7
# K3: (rows, D, dtype, scale dtype, kind, iters).  "main" the llama3.2-1b
# prefill norm (4 x 1024 tokens of 2048), "rwkv" the rwkv6-7b one (4096);
# "ragged" an odd row count and width; "strided" the rows of a wider
# tensor (16-byte aligned, the vector path); "unaligned" the same at an
# odd column offset (the element path); "small" rows of magnitude 1e-3,
# where eps is not negligible; "wide" float32 rows of rwkv6's 4096, the
# width of the smoke's float32 rwkv6 model; "tail" a row count that is
# not a multiple of the rows a block of the register form walks.
RMS_CASES = [(4096, 2048, "bfloat16", "bfloat16", "main", 50),
             (4096, 4096, "bfloat16", "bfloat16", "rwkv", 50),
             (4096, 2048, "float32", "float32", "main", 20),
             (1000, 1600, "bfloat16", "float32", "ragged", 20),
             (1000, 1600, "float32", "float32", "ragged", 20),
             (4096, 2048, "bfloat16", "bfloat16", "strided", 20),
             (1000, 2048, "float32", "float32", "unaligned", 20),
             (1000, 2048, "float32", "float32", "small", 20),
             (1000, 4096, "float32", "float32", "wide", 20),
             (4097, 2048, "bfloat16", "bfloat16", "tail", 20),
             (1001, 4096, "float32", "float32", "tail", 20)]
# K4/K5: the fig5 scalability shape (benchmarks/fig5_scalability.py):
# philly_trace(n, seed=1) on grown_cluster(n) at t=0, and the bursty
# arrivals on a 3-pod multi_cluster with a quarter of mixed nodes after the
# last burst.  The main row of the kernels record is n=2048 on grown.
SCHED_SIZES = (256, 1024, 2048)
SCHED_MAIN = (2048, "grown")
# K5's further cases: a fractional carry, the n=256 grown tables with 0.5
# added to and taken from every third key's free (``frac_tables``); random
# pool orders over n_nodes = 80 (L = 1012, walks into a partial last
# chunk) and 170 (L = 2176, walks of up to 9 chunks) node rows
# (``random_tables``); the first of those with every window cut at the last
# unit ("cut"); the first greedy consult of phase hadare ("hadare",
# ``hadare_tables``: its HADARE_JOBS parents' single-node copies)
EXTRA_K5 = (("frac", 0.5), ("frac", -0.5), ("random", 80), ("random", 170),
            ("cut", 80), ("hadare", 48))
# K4's further cases (``k4_tables``): (kind, jobs)
EXTRA_K4 = (("busy", 256), ("busy", 2048), ("wide", 200), ("mixed", 400),
            ("queue", 8192), ("hadare", 48))
# the planning horizon of the fig5 round's PriceState (one week)
HORIZON = 7 * 24 * 3600.0
# the decision-latency sweep of the schedule phase (both solvers)
SWEEP_SIZES = (64, 256, 1024, 2048)
SIM_JOBS = 256
# the faulted round run's trace, cut from SIM_JOBS to keep the smoke's
# time: grown_cluster(48) is 15 nodes, the run takes 322 rounds, 18 of
# its consults queue more than 24 jobs (the greedy path, K5)
FAULT_ROUND_JOBS = 48
# the failure model of the faulted runs (phases 7, 8 and 10): on
# grown_cluster(256), 32 nodes, it draws 94 windows over its week, 27 of
# them spot reclaims; on grown_cluster(48), 46 windows, 7 spot
FAULT_MODEL = dict(seed=7, mtbf_hours=72.0, spot_frac=0.2,
                   spot_reclaim_hours=24.0)
# The JAX package's results for the same runs, each with its own
# HadarScheduler(solver="numpy") and FAULT_MODEL on the fig5 grown
# cluster (benchmarks/fig5_scalability.grown_cluster), run once on a CPU:
# repro.sim.engine.simulate_events of philly_trace(SIM_JOBS, seed=1), and
# simulate_rounds of philly_trace(FAULT_ROUND_JOBS, seed=1).
REF_EVENTS = {"n_events": 1190, "sched_calls": 929, "evictions": 99,
              "avg_jct_s": 118650.07469017516,
              "makespan_s": 230066.13249397563}
REF_ROUNDS_FAULTED = {"rounds": 322, "evictions": 10,
                      "avg_jct_s": 44677.16528191138,
                      "makespan_s": 115652.0}
REF_REL_TOL = 1e-9
# phase 9: philly_mini on simulation_cluster(), whose nodes 10-14 are its
# K80s; the type outage downs them together (R drops from 3 to 2) over
# four of the trace's arrivals, and over the first consults of a 48-job
# fig5 trace, whose queue takes the greedy path (K5)
MINI_TRACE = ROOT / "examples" / "traces" / "philly_mini.csv"
MINI_FAULTS = ROOT / "examples" / "traces" / "philly_mini_faults.csv"
K80_NODES = range(10, 15)
K80_OUTAGE = (7200.0, 40000.0)
OUTAGE_JOBS = 48
# phase 10: HadarE on the fig5 trace of HADARE_JOBS parents on
# grown_cluster(48) (15 nodes, so 15 single-node copies a parent and
# queues of up to 720 copies, K4's bucket 1024) under FAULT_MODEL, and on
# the paper's physical clusters (aws_cluster, testbed_cluster) for every
# mix at HADARE_ROUND seconds a round
HADARE_JOBS = 48
HADARE_ROUND = 90.0
# The JAX package's result for the same run: repro.sim.adapters.
# simulate_hadare of philly_trace(HADARE_JOBS, seed=1) on the fig5 grown
# cluster with its own HadarScheduler(solver="numpy") passed as
# scheduler= and FAULT_MODEL, run once on a CPU (37 of the 48 parents
# finish: the other 11 gangs exceed every node, and copies are
# single-node)
REF_HADARE = {"rounds": 170, "evictions": 3,
              "avg_jct_s": 30934.402411765943, "makespan_s": 61200.0}
# timed forward calls per prefill path (the median is reported)
FORWARD_REPS = 5
# H100 SXM float64 peak without tensor cores (NVIDIA data sheet)
PEAK_F64 = 34e12
# H100 L2 cache, bytes (NVIDIA data sheet)
L2_BYTES = 50e6


def kernel_cases():
    """(B, Hq, Hkv, S, D, dtype, causal, window, model_layout, iters) of
    every case the kernel phase checks.  The first llama case takes
    transposed (B,S,H,D) views and writes a transposed (B,S,Hq,D) output,
    as ``ops.flash_attention`` calls the kernel from ``forward``; it is
    the main-path row of the kernels record."""
    cases = [(B, Hq, Hkv, S, D, dt, c, w, False, 10)
             for (B, Hq, Hkv, S, D) in SWEEP
             for dt in ("float32", "bfloat16") for c, w in MASKS]
    cases += [LLAMA_PREFILL + (True, 20),
              (4, 32, 8, 2048, 64, "bfloat16", True, 8192, False, 20),
              (1, 32, 8, 1000, 64, "bfloat16", True, 8192, False, 20),
              (1, 32, 8, 1000, 64, "bfloat16", False, 0, False, 10),
              (1, 32, 8, 1000, 64, "float32", False, 0, False, 10),
              (2, 4, 2, 100, 32, "bfloat16", False, 0, False, 10),
              (1, 32, 8, 2048, 64, "bfloat16", True, 300, False, 10),
              (2, 16, 4, 1024, 128, "bfloat16", True, 0, False, 10)]
    return cases


def rwkv_cases():
    """(B, H, S, D, dtype, kind, iters) of every K2 case.  r, k, v, u and
    the output are in ``dtype``; w, S_0 and S_T are float32.  Kinds:
    "sweep" the JAX test's shapes; "main" the rwkv6-7b prefill shape, on
    transposed (B,S,H,D) views as ``ops.rwkv6_scan`` passes them from
    ``forward`` (the main-path row of the kernels record); "ragged" S=1000;
    "long" decays in (0.951, 0.99988), the long memory of trained rwkv6
    layers; "chain" two halves with the carried state against one scan;
    "short" S=17, shorter than the TPU kernel's chunk of 32 (one staged
    chunk of 16 and a ragged step); "underflow" w = 0.01 over
    steps 32-95, a whole chunk whose decay product underflows to 0; "d16"
    and "d128" the smallest and largest head dims, at ragged lengths."""
    cases = [(B, H, S, D, dt, "sweep", 10) for (B, H, S, D) in RWKV_SWEEP
             for dt in ("float32", "bfloat16")]
    cases += [RWKV_MAIN + ("bfloat16", "main", 20),
              (1, 64, 1000, 64, "bfloat16", "ragged", 10),
              (2, 16, 1024, 64, "bfloat16", "long", 10),
              (2, 8, 512, 64, "float32", "chain", 10),
              (2, 4, 17, 64, "bfloat16", "short", 10),
              (1, 8, 160, 64, "float32", "underflow", 10),
              (2, 4, 100, 16, "float32", "d16", 10),
              (1, 8, 200, 128, "bfloat16", "d128", 10)]
    return cases


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# The SM clock of an H100 SXM tops out at 1.98 GHz, so a spin of n cycles
# lasts at least n / SPIN_HZ seconds.
SPIN_HZ = 2.0e9


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """The card's time per call of ``fn``: a spin kernel holds the stream
    while the host enqueues all the timed calls, so they run back to back
    and the events time the card, not the host's launch rate (a launch
    through a Python wrapper costs the host tens of microseconds, more
    than K3 or K4 take on the card).  ``fn`` must not synchronise."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold = 2 * (time.perf_counter() - t) * iters + 1e-3
    for _ in range(3):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold * SPIN_HZ))
        h0 = time.perf_counter()
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        enqueued = time.perf_counter() - h0
        torch.cuda.synchronize()
        if enqueued < hold:  # the card was still held: back to back
            return t0.elapsed_time(t1) / iters
        hold *= 4
    raise RuntimeError("device_ms: the host could not enqueue the calls "
                       "within the hold")


def cold_copies(x, per_call_bytes: float) -> list:
    """Copies of ``x`` (same sizes, strides and storage offset), enough
    that cycling through them moves three L2 caches' worth of bytes
    (``per_call_bytes`` a call) before a copy comes round again: each
    call then reads its input from device memory, as the byte bound
    assumes, and not from L2, where back-to-back calls on one input find
    it."""
    import math
    import torch
    n = max(2, math.ceil(3 * L2_BYTES / per_call_bytes))
    whole = torch.as_strided(x, (x.untyped_storage().nbytes()
                                 // x.element_size(),), (1,), 0)
    return [torch.as_strided(whole.clone(), x.size(), x.stride(),
                             x.storage_offset()) for _ in range(n)]


def cycled(fns: list):
    """One call that calls the next of ``fns`` in turn."""
    import itertools
    it = itertools.cycle(fns)
    return lambda: next(it)()


def attention_bound(B, Hq, Hkv, S, D, causal, window, dtype):
    """Least time for the function: q, k, v read once and o written once
    against HBM, or the (q k, p v) products that the mask leaves, at the
    type's peak.  Returns (ms, "bytes" | "operations", flops, bytes)."""
    pairs = 0
    for r in range(S):
        lo = max(0, r - window + 1) if window > 0 else 0
        hi = r + 1 if causal else S
        pairs += max(0, hi - lo)
    flops = 4 * D * B * Hq * pairs
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


# ---------------------------------------------------------------------------
# phase 1: kernel
# ---------------------------------------------------------------------------

def sdpa_call(q, k, v, causal, window):
    """One PyTorch call computing the same attention (timing yardstick)."""
    import torch
    import torch.nn.functional as F
    S = q.shape[2]
    mask = None
    if window > 0 and window < S:
        i = torch.arange(S, device=q.device)
        mask = (i[None, :] > i[:, None] - window)
        if causal:
            mask &= i[None, :] <= i[:, None]
    is_causal = causal and mask is None
    try:
        F.scaled_dot_product_attention(q[:, :, :1], k, v, enable_gqa=True)
        kk, vv, extra = k, v, {"enable_gqa": True}
    except (TypeError, RuntimeError):  # no GQA support: expand kv heads
        G = q.shape[1] // k.shape[1]
        kk, vv, extra = (k.repeat_interleave(G, 1), v.repeat_interleave(G, 1),
                         {})
    return lambda: F.scaled_dot_product_attention(
        q, kk, vv, attn_mask=mask, is_causal=is_causal, **extra)


def rowblock_rel_err(out, want, rows: int = ROW_BLOCK) -> float:
    """Max over (batch, head, ``rows``-row block) of the block's max abs
    error over its largest |want|, for kernel-layout (B,H,S,D) outputs.
    Early causal rows average few values and are large, late rows small;
    scaling by the block keeps a wrong late row from hiding under the
    early rows' rounding."""
    import torch.nn.functional as F
    err = (out.float() - want.float()).abs().amax(-1)  # (B,H,S)
    ref = want.float().abs().amax(-1)
    pad = -err.shape[-1] % rows
    err = F.pad(err, (0, pad)).unflatten(-1, (-1, rows)).amax(-1)
    ref = F.pad(ref, (0, pad)).unflatten(-1, (-1, rows)).amax(-1)
    return float((err / ref.clamp_min(1e-30)).max())


def gate(out, want, dtype: str) -> dict:
    """Errors of one kernel output against its plain version, and whether
    they are within the dtype's limit."""
    abs_err = float((out.float() - want.float()).abs().max())
    rel_err = rowblock_rel_err(out, want)
    if dtype == "float32":
        ok, tol = abs_err < F32_TOL, F32_TOL
    else:
        ok, tol = rel_err < BF16_REL_TOL, BF16_REL_TOL
    return {"max_abs_err": abs_err, "max_rel_err": rel_err,
            "gated_on": "max_abs_err" if dtype == "float32"
            else "max_rel_err", "tol": tol, "ok": ok}


def check_case(case, gen):
    """Draw one case's inputs, run the kernel twice and its plain version
    once.  Returns (errors from ``gate`` with "deterministic": the two
    kernel outputs are bitwise equal, (q, k, v, plain output, a fresh
    output of the case's layout or None)).  Model-layout cases take
    transposed views of (B,S,H,D) tensors and write into a transposed
    view of a (B,S,Hq,D) tensor, as ``ops.flash_attention`` does."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, Hq, Hkv, S, D, dtype, causal, window, model_layout, _ = case
    dt = getattr(torch, dtype)

    def make(H):
        if model_layout:
            t = torch.randn((B, S, H, D), generator=gen, device="cuda")
            return t.to(dt).transpose(1, 2)
        return torch.randn((B, H, S, D), generator=gen, device="cuda").to(dt)

    def dest():
        if not model_layout:
            return None
        return torch.empty((B, S, Hq, D), dtype=dt,
                           device="cuda").transpose(1, 2)

    q, k, v = make(Hq), make(Hkv), make(Hkv)
    out = fa.flash_attention(q, k, v, causal=causal, window=window,
                             out=dest())
    again = fa.flash_attention(q, k, v, causal=causal, window=window,
                               out=dest())
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal, window)
    errs = gate(out, want, dtype)
    errs["deterministic"] = bool(torch.equal(out, again))
    errs["ok"] = errs["ok"] and errs["deterministic"]
    return errs, (q, k, v, want, dest())


def kernel_case(case, gen):
    """One case: check against the plain version (raises if over the
    limit), then time the kernel, the plain version and SDPA."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, Hq, Hkv, S, D, dtype, causal, window, model_layout, iters = case
    errs, (q, k, v, want, out) = check_case(case, gen)
    if not errs["deterministic"]:
        raise RuntimeError(f"flash_attention gave two outputs for the same "
                           f"inputs at {case[:8]}")
    if not errs["ok"]:
        raise RuntimeError(
            f"flash_attention disagrees with its plain version at {case[:8]}:"
            f" {errs['gated_on']} {errs[errs['gated_on']]} >= {errs['tol']}")
    lib = sdpa_call(q, k, v, causal, window)
    lib_err = float((lib().float() - want.float()).abs().max())
    ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                              window=window, out=out),
                   iters)
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal,
                                                       window),
                       max(2, iters // 4))
    library_ms = device_ms(lib, iters)
    bound_ms, bound_by, flops, nbytes = attention_bound(
        B, Hq, Hkv, S, D, causal, window, dtype)
    row = {"shape": [B, Hq, Hkv, S, D], "dtype": dtype, "causal": causal,
           "window": window, "model_layout": model_layout, **errs,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library_max_abs_err": lib_err, "bound_ms": bound_ms,
           "bound_by": bound_by, "flops": flops, "bytes": nbytes,
           "tflops": flops / ms / 1e9}
    log(f"[kernel] B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} {dtype:8s} "
        f"causal={int(causal)} window={window:5d}  "
        f"abs_err={errs['max_abs_err']:.3g} rel_err={errs['max_rel_err']:.3g} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} ({ms / library_ms:.2f}x) "
        f"bound_ms={bound_ms:.4f} ({bound_by}) {row['tflops']:.1f} TFLOP/s")
    return row


def rwkv_inputs(case, gen):
    """r, k, v, w (B,H,S,D), u (H,D) and S_0 (B,H,D,D) of one K2 case, with
    the statistics of the JAX package's rwkv6 tests (r, k, v ~ 0.5 N;
    w = sigmoid(N - 1) * 0.98 + 0.01; u ~ 0.3 N; S_0 ~ 0.2 N)."""
    import torch
    B, H, S, D, dtype, kind, _ = case
    dt = getattr(torch, dtype)
    model_layout = kind == "main"
    shape = (B, S, H, D) if model_layout else (B, H, S, D)

    def normal(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def seq(t):
        return t.transpose(1, 2) if model_layout else t

    r, k, v = (seq(normal(shape, 0.5).to(dt)) for _ in range(3))
    if kind == "long":  # w = exp(-exp(x)), x in (-9, -3)
        x = torch.rand(shape, generator=gen, device="cuda") * 6 - 9
        w = torch.exp(-torch.exp(x))
    else:
        w = torch.sigmoid(normal(shape) - 1) * 0.98 + 0.01
    if kind == "underflow":  # 0.01 ** 32 = 1e-64: below float32's range
        w[:, :, 32:96] = 0.01
    return (r, k, v, seq(w), normal((H, D), 0.3).to(dt),
            normal((B, H, D, D), 0.2))


def state_gate(errs: dict, s, want_s) -> dict:
    """Add the final state's errors to ``errs`` (from ``gate``): max abs
    error within STATE_TOL and, over the largest |state|, STATE_REL_TOL."""
    err = float((s - want_s).abs().max())
    rel = err / max(float(want_s.abs().max()), 1e-30)
    errs.update(state_abs_err=err, state_rel_err=rel,
                ok=errs["ok"] and err < STATE_TOL and rel < STATE_REL_TOL)
    return errs


def rwkv_check_case(case, gen):
    """Draw one K2 case's inputs and run the kernel twice: against its
    plain version (output by ``gate``, final state by ``state_gate``), or
    for a "chain" case its two halves against its one scan (CHAIN_TOL).
    "deterministic": the two runs' outputs and states are bitwise equal.
    Returns (errors, inputs)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rk
    dtype, kind = case[4], case[5]
    args = rwkv_inputs(case, gen)
    out, s = rk.rwkv6_scan(*args)
    out2, s2 = rk.rwkv6_scan(*args)
    torch.cuda.synchronize()
    same = bool(torch.equal(out, out2) and torch.equal(s, s2))
    if kind == "chain":
        r, k, v, w, u, s0 = args
        h = r.shape[2] // 2
        o1, s1 = rk.rwkv6_scan(r[:, :, :h], k[:, :, :h], v[:, :, :h],
                               w[:, :, :h], u, s0)
        o2, want_s = rk.rwkv6_scan(r[:, :, h:], k[:, :, h:], v[:, :, h:],
                                   w[:, :, h:], u, s1)
        errs = gate(torch.cat([o1, o2], 2), out, dtype)
        state_err = float((want_s - s).abs().max())
        errs.update(gated_on="max_abs_err", tol=CHAIN_TOL,
                    state_abs_err=state_err,
                    state_rel_err=state_err / float(s.abs().max()),
                    deterministic=same,
                    ok=errs["max_abs_err"] < CHAIN_TOL
                    and state_err < CHAIN_TOL and same)
        return errs, args
    want, want_s = ref.rwkv6_scan_ref(*args)
    errs = state_gate(gate(out, want, dtype), s, want_s)
    errs.update(deterministic=same, ok=errs["ok"] and same)
    return errs, args


def rwkv_bound(r, w, u):
    """Least time for one scan: r, k, v, w, u, S_0 read once and o, S_T
    written once, or 5 D^2 + 5 D float32 operations per (b, h, t) (k^T v,
    the decayed update, r S and the bonus) at the f32 CUDA-core peak.
    Returns (ms, "bytes" | "operations", flops, bytes)."""
    B, H, S, D = r.shape
    n = B * H * S * D
    nbytes = (4 * n * r.element_size() + n * w.element_size()
              + u.numel() * u.element_size() + 2 * B * H * D * D * 4)
    flops = B * H * S * (5 * D * D + 5 * D)
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def rwkv_case(case, gen):
    """One K2 case: check (raises if over a limit), then time the kernel
    and the plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rk
    B, H, S, D, dtype, kind, iters = case
    errs, args = rwkv_check_case(case, gen)
    if not errs["deterministic"]:
        raise RuntimeError(f"rwkv6_scan gave two results for the same "
                           f"inputs at {case[:6]}")
    if not errs["ok"]:
        raise RuntimeError(
            f"rwkv6_scan disagrees at {case[:6]}: {errs['gated_on']} "
            f"{errs[errs['gated_on']]} (limit {errs['tol']}), state "
            f"{errs['state_abs_err']} ({errs['state_rel_err']} of its "
            f"largest value)")
    ms = device_ms(lambda: rk.rwkv6_scan(*args), iters)
    plain_ms = cuda_ms(lambda: ref.rwkv6_scan_ref(*args), 1, warmup=1)
    bound_ms, bound_by, flops, nbytes = rwkv_bound(args[0], args[3], args[4])
    row = {"shape": [B, H, S, D], "dtype": dtype, "w_dtype": "float32",
           "kind": kind, **errs, "ms": ms, "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
           "flops": flops, "bytes": nbytes}
    log(f"[kernel] rwkv6_scan B={B} H={H} S={S} D={D} {dtype:8s} {kind:6s} "
        f"abs_err={errs['max_abs_err']:.3g} rel_err={errs['max_rel_err']:.3g}"
        f" state_err={errs['state_abs_err']:.3g} "
        f"state_rel_err={errs['state_rel_err']:.3g} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    return row


def row_rel_err(out, want) -> float:
    """Max over rows of the row's max abs error over its largest |want|
    (K3's bf16 gate)."""
    err = (out.float() - want.float()).abs().amax(-1)
    ref = want.float().abs().amax(-1).clamp_min(1e-30)
    return float((err / ref).max())


def rms_inputs(case, gen):
    """x (rows, D) of the case's kind and a scale of 1 + 0.1 N, both on
    the card."""
    import torch
    rows, D, dtype, sdtype, kind, _ = case
    dt, sdt = getattr(torch, dtype), getattr(torch, sdtype)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    if kind == "strided":
        x = normal(rows, D + 1024)[:, 512:512 + D]
    elif kind == "unaligned":
        x = normal(rows, D + 2)[:, 1:1 + D]
    else:
        x = normal(rows, D) * (1e-3 if kind == "small" else 1.0)
    return x.to(dt), (1.0 + 0.1 * normal(D)).to(sdt)


def rms_check_case(case, gen):
    """Draw one K3 case's inputs and run the kernel twice against its
    plain version; "deterministic": the two outputs are bitwise equal.
    Returns (errors, (x, scale, plain output))."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk
    x, scale = rms_inputs(case, gen)
    out = rk.rmsnorm(x, scale, 1e-5)
    again = rk.rmsnorm(x, scale, 1e-5)
    torch.cuda.synchronize()
    same = bool(torch.equal(out, again))
    want = ref.rmsnorm_ref(x, scale, 1e-5)
    abs_err = float((out.float() - want.float()).abs().max())
    rel_err = row_rel_err(out, want)
    if case[2] == "float32":
        errs = {"gated_on": "max_abs_err", "tol": RMS_F32_TOL,
                "ok": abs_err < RMS_F32_TOL}
    else:
        errs = {"gated_on": "max_rel_err", "tol": RMS_BF16_ULP,
                "ok": rel_err <= RMS_BF16_ULP}
    errs.update(max_abs_err=abs_err, max_rel_err=rel_err,
                deterministic=same,
                ok=errs["ok"] and same and out.dtype == x.dtype
                and tuple(out.shape) == tuple(x.shape))
    return errs, (x, scale, want)


def rms_library(x, scale):
    """One PyTorch call computing the same norm (``F.rms_norm``, a
    yardstick only), or None where this torch has none for these dtypes."""
    import torch.nn.functional as F
    if not hasattr(F, "rms_norm") or scale.dtype != x.dtype:
        return None
    return lambda: F.rms_norm(x, (x.shape[-1],), scale, 1e-5)


def rms_case(case, gen):
    """One K3 case: check (raises if over the limit), then time the
    kernel, the plain version and ``F.rms_norm``.  ``ms`` and
    ``library_ms`` read x from device memory (``cold_copies``); the
    ``warm_`` times call on one x back to back, so x is in L2."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk
    rows, D, dtype, sdtype, kind, iters = case
    errs, (x, scale, want) = rms_check_case(case, gen)
    if not errs["deterministic"]:
        raise RuntimeError(f"rmsnorm gave two outputs for the same inputs "
                           f"at {case[:5]}")
    if not errs["ok"]:
        raise RuntimeError(f"rmsnorm disagrees with its plain version at "
                           f"{case[:5]}: {errs['gated_on']} "
                           f"{errs[errs['gated_on']]} (limit {errs['tol']})")
    nbytes = (2 * rows * D * x.element_size()
              + D * scale.element_size())
    xs = cold_copies(x, nbytes)
    ms = device_ms(cycled([lambda c=c: rk.rmsnorm(c, scale, 1e-5)
                           for c in xs]), iters)
    warm_ms = device_ms(lambda: rk.rmsnorm(x, scale, 1e-5), iters)
    plain_ms = cuda_ms(lambda: ref.rmsnorm_ref(x, scale, 1e-5), iters)
    lib = rms_library(x, scale)
    library_ms = library_warm_ms = lib_err = None
    if lib is not None:
        library_ms = device_ms(cycled([rms_library(c, scale) for c in xs]),
                               iters)
        library_warm_ms = device_ms(lib, iters)
        lib_err = float((lib().float() - want.float()).abs().max())
    flops = 4 * rows * D
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
    row = {"shape": [rows, D], "dtype": dtype, "scale_dtype": sdtype,
           "kind": kind, **errs, "ms": ms, "warm_ms": warm_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_warm_ms": library_warm_ms,
           "library_max_abs_err": lib_err,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bytes": nbytes, "flops": flops}
    log(f"[kernel] rmsnorm {rows}x{D} {dtype:8s} scale {sdtype:8s} "
        f"{kind:9s} abs_err={errs['max_abs_err']:.3g} "
        f"row_rel_err={errs['max_rel_err']:.3g} kernel_ms={ms:.5f} "
        f"(warm {warm_ms:.5f}) plain_ms={plain_ms:.4f} library_ms="
        f"{library_ms} (warm {library_warm_ms}) "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
    return row


# ---------------------------------------------------------------------------
# K4 / K5: the scheduler kernels on the fig5 shape
# ---------------------------------------------------------------------------

def fig5_round(n: int, topo: str):
    """(jobs, cluster, now) of the fig5 scalability round at n jobs:
    ``grown`` (all jobs at t=0 on grown_cluster(n)) or ``bursty`` (bursty
    arrivals on the 3-pod multi_cluster, scheduled after the last
    burst)."""
    from repro_torch.core.trace import grown_cluster, multi_cluster, \
        philly_trace
    if topo == "grown":
        cluster = grown_cluster(n)
        return philly_trace(n_jobs=n, seed=1, types=cluster.gpu_types), \
            cluster, 0.0
    cluster = multi_cluster(n_pods=3, nodes_per_pod=max(5, n // 24),
                            gpus_per_node=4,
                            pod_types=["v100", "p100", "k80"],
                            mixed_frac=0.25, seed=2)
    jobs = philly_trace(n_jobs=n, seed=1, types=cluster.gpu_types,
                        arrival_pattern="bursty")
    return jobs, cluster, max(j.arrival for j in jobs)


def sched_tables(n: int, topo: str):
    """The host tables of the first K4 launch and of a K5 launch over the
    whole greedy commit order, as ``HadarScheduler.schedule`` builds them
    at the fig5 round's state (every active job queued, nothing
    committed)."""
    from repro_torch.core import batch_solver as bs
    from repro_torch.core.dp import _find_alloc_arrays
    from repro_torch.core.pricing import PriceState
    from repro_torch.core.utility import effective_throughput as util
    jobs, cluster, now = fig5_round(n, topo)
    queue = sorted([j for j in jobs if j.arrival <= now],
                   key=lambda j: (j.arrival, j.job_id))
    ps = PriceState(cluster, queue, HORIZON, util, now)
    avail, gamma = ps.free_arr.copy(), ps.gamma_arr.copy()
    k4 = bs.pricing_tables(queue, avail, gamma, ps, now, util,
                           bs.bucket_size(len(queue)))
    cands = [_find_alloc_arrays(j, avail, gamma, ps, now, util, False)
             for j in queue]
    dens = sorted(((c.payoff / max(1, j.n_workers), i)
                   for i, (j, c) in enumerate(zip(queue, cands)) if c),
                  key=lambda t: -t[0])
    order = [queue[i] for _, i in dens]
    k5 = bs.scan_tables(order, avail, gamma, ps, now, util,
                        bs.bucket_size(len(order)))
    return k4, k5, len(queue), len(order)


def _compare(outs, wants, names, pay_fields=()) -> dict:
    """Every result of a scheduler kernel against its plain version:
    bitwise, except the fields in ``pay_fields`` (spread payoffs), which
    may differ by one ulp.  Returns the verdict and the differences."""
    import torch
    mism, ulps = [], 0
    for name, got, want in zip(names, outs, wants):
        if got.dtype != want.dtype or got.shape != want.shape:
            mism.append(name)
            continue
        if torch.equal(got, want):
            continue
        if name in pay_fields:
            d = (got.view(torch.int64) - want.view(torch.int64)).abs()
            ulps = max(ulps, int(d.max()))
            if ulps <= 1:
                continue
        mism.append(name)
    max_abs = max((float((g.double() - w.double()).abs().max())
                   for g, w in zip(outs, wants)
                   if g.is_floating_point() and g.numel()), default=0.0)
    return {"ok": not mism, "mismatched": mism, "pay_ulps": ulps,
            "max_abs_err": max_abs}


FIND_ALLOC_OUT = ("feasible", "k_first", "j_last", "take", "packed_cost",
                  "packed_payoff", "sp_ok", "sp_pay", "sp_jmax", "sp_nserv",
                  "sp_counts")
COMMIT_SCAN_OUT = ("free", "gamma", "won", "win", "counts", "win2",
                   "win2_pay", "sp_nserv")


def _same_bits(xs, ys) -> bool:
    import torch
    return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(xs, ys))


def find_alloc_check(tab):
    """K4 on the card, twice, against its plain version on the same
    tables; the two launches must agree bitwise.  Returns (verdict, args,
    the kernel's results)."""
    import torch
    from repro_torch.core import batch_solver as bs
    from repro_torch.core.dp import COMM_COST_FRAC
    from repro_torch.kernels import find_alloc as fk
    from repro_torch.kernels import ref
    args = bs._to(torch.device("cuda"),
                  *(tab[k] for k in bs.FIND_ALLOC_ARGS))
    kw = (tab["n_nodes"], COMM_COST_FRAC, tab["wmax"])
    out = fk.find_alloc(*args, *kw)
    again = fk.find_alloc(*args, *kw)
    torch.cuda.synchronize()
    want = ref.find_alloc_ref(*args, *kw)
    verdict = _compare(out, want, FIND_ALLOC_OUT)
    verdict["deterministic"] = _same_bits(out, again)
    verdict["ok"] = verdict["ok"] and verdict["deterministic"]
    return verdict, args, out


def commit_scan_check(tab, plain=None):
    """K5 on the card, twice, against its plain version on the same
    tables; the two launches must agree bitwise.  ``plain``: the last
    item an earlier call on these tables returned, reused.  Returns
    (verdict, args, the kernel's results, per-step pool reads of the
    plain version, (the plain version's results, those reads))."""
    import torch
    from repro_torch.core import batch_solver as bs
    from repro_torch.core.dp import COMM_COST_FRAC
    from repro_torch.kernels import commit_scan as ck
    from repro_torch.kernels import ref
    args = bs._to(torch.device("cuda"),
                  *(tab[k] for k in bs.COMMIT_SCAN_ARGS))
    kw = (tab["n_nodes"], COMM_COST_FRAC, tab["wmax"])
    out = ck.commit_scan(*args, *kw)
    again = ck.commit_scan(*args, *kw)
    torch.cuda.synchronize()
    if plain is None:
        need = []
        plain = (ref.commit_scan_ref(*args, *kw, need=need), need)
    verdict = _compare(out, plain[0], COMMIT_SCAN_OUT, ("win2_pay",))
    verdict["deterministic"] = _same_bits(out, again)
    verdict["ok"] = verdict["ok"] and verdict["deterministic"]
    return verdict, args, out, plain[1], plain


def frac_tables(delta: float, n: int = 256, topo: str = "grown"):
    """The K5 tables of ``sched_tables(n, topo)`` with ``delta`` added to
    every third key's free (keys with at least one free unit when delta
    is negative): a fractional carry.  Adding 0.5 pushes a key's window
    past the last unit C - 1 (gamma + free = C at the fig5 state), where
    it is cut; taking 0.5 leaves ceil(free) units inside it."""
    import numpy as np
    tab = dict(sched_tables(n, topo)[1])
    free = tab["free"].copy()
    keys = np.arange(0, len(free), 3)
    if delta < 0:
        keys = keys[free[keys] >= 1.0]
    free[keys] += delta
    tab["free"] = free
    return tab


def _time_bound(nbytes: float, flops: float):
    t_ops, t_bytes = flops / PEAK_F64, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def find_alloc_bound(tab) -> tuple:
    """Least time for one K4 launch on these tables: the shared tables and
    each job's rows read once, each job's pool read through the W-th
    eligible unit of its longest prefix walk (s_valid, s_rank; price and
    key of the chosen units), the slot tables written once; or its
    float64 operations (prefix sums, takes and cost sums over the (node,
    rank) cells, the chosen units' sums) at the f64 peak."""
    B, M = tab["rank"].shape
    R = tab["u_tab"].shape[1]
    N = tab["n_nodes"]
    reach, chosen = walk_reach(tab)
    walk = reach.max(axis=1)
    nbytes = (tab["avail"].nbytes + tab["cumP"].nbytes
              + tab["node_row"].nbytes
              + B * (8 + 4 + 1 + M * 4 + R * 8)
              + int(walk.sum()) * 5 + int(chosen.sum()) * 12
              + B * N * (1 + 4 + 4 + 8 + 8 + R * 8)
              + B * R * (1 + 8 + 4 + 4 + M * 4))
    flops = B * N * R * 6 + int(chosen.sum()) * 2
    return _time_bound(nbytes, flops) + (nbytes, flops)


def walk_reach(tab) -> tuple:
    """Per job and spread prefix k = 1..R of K4's tables, as the plain
    version walks the job's pool: (the entries read through its W-th
    eligible unit, or the whole pool when it has fewer; 0 for a job that
    asks for no unit or may use no type), (the units it chooses), both
    (B, R) int64."""
    import numpy as np
    B, L = tab["s_rank"].shape
    R = tab["u_tab"].shape[1]
    W = tab["W"].astype(np.int64)
    reach = np.zeros((B, R), dtype=np.int64)
    chosen = np.zeros((B, R), dtype=np.int64)
    for k in range(1, R + 1):
        elig = tab["s_valid"] & (tab["s_rank"] < k)
        cs = np.cumsum(elig, axis=1)
        total = cs[:, -1] if L else np.zeros(B, dtype=np.int64)
        r = np.where(total >= W, np.argmax(cs >= W[:, None], axis=1) + 1, L)
        reach[:, k - 1] = np.where((W == 0) | (tab["Kj"] == 0), 0, r)
        chosen[:, k - 1] = np.minimum(W, total)
    return reach, chosen


def walk_stats(tab) -> dict:
    """How deep the plain version's walks go on K4's tables: the walks
    (job, prefix) that read past the pool's first 32-entry chunk, those
    that read into its partial last chunk (none when the pool length L is
    a multiple of 32), and those that end short of W (the whole pool)."""
    import numpy as np
    reach, chosen = walk_reach(tab)
    L = tab["s_rank"].shape[1]
    tail = L - L % 32
    short = (reach == L) & (chosen < tab["W"].astype(np.int64)[:, None])
    return {"walks": int((reach > 0).sum()),
            "past_chunk1": int((reach > 32).sum()),
            "partial_chunk": int((reach > tail).sum()) if L % 32 else 0,
            "short_of_W": int(short.sum())}


def commit_scan_bound(tab, need) -> tuple:
    """Least time for one K5 launch: the state, the tables and each step's
    rows read once, each step's pool read (s_m, s_u, s_rank) through the
    W-th eligible unit of its longest prefix walk as the plain version
    counted it (none for a prefix with fewer than W eligible units: the
    carry tells), the chosen units' price and node, and the counts
    written once; or its float64 operations per step (prefix sums,
    unit-price sums, the chosen units' sums)."""
    B, M = tab["rank"].shape
    R = tab["u_tab"].shape[1]
    N = tab["n_nodes"]
    W = tab["W"]
    nbytes = (2 * (tab["free"].nbytes + tab["gamma"].nbytes)
              + tab["P_tab"].nbytes + tab["node_row"].nbytes
              + B * (8 + 4 + 1 + M * 4 + R * 8)
              + sum(r for r, _ in need) * 12 + sum(c for _, c in need) * 12
              + B * (1 + 4 + M * 4 + 4 + 8 + R * 4))
    flops = B * (N * R * 6 + int(W.max(initial=0)) * (M + R))
    return _time_bound(nbytes, flops) + (nbytes, flops)


def sched_case(n: int, topo: str):
    """K4 and K5 on one fig5 round's tables: check (raises on any
    difference; K5's runner-up payoff may differ by one ulp), then time
    each kernel on the card (``ms``), each call of its wrapper as the
    decision path makes it (``wrapper_ms``: checks, allocation, a read of
    max W, launch) and its plain version.  Returns two rows."""
    from repro_torch.core.dp import COMM_COST_FRAC
    from repro_torch.kernels import commit_scan as ck
    from repro_torch.kernels import find_alloc as fk
    from repro_torch.kernels import ref
    k4, k5, J, Jc = sched_tables(n, topo)
    rows = []
    for name, tab, check, mod, plain, n_jobs in (
            ("find_alloc", k4, find_alloc_check, fk, ref.find_alloc_ref, J),
            ("commit_scan", k5, commit_scan_check, ck, ref.commit_scan_ref,
             Jc)):
        res = check(tab)
        verdict, args, out = res[:3]
        if not verdict["ok"]:
            raise RuntimeError(f"{name} disagrees with its plain version "
                               f"at n={n} {topo}: {verdict}")
        kw = (tab["n_nodes"], COMM_COST_FRAC, tab["wmax"])
        ms = device_ms(lambda: mod.launch(args, out, *kw), 10)
        wrapper_ms = cuda_ms(lambda: getattr(mod, name)(*args, *kw), 10)
        plain_ms = cuda_ms(lambda: plain(*args, *kw), 1, warmup=0)
        bound = (find_alloc_bound(tab) if name == "find_alloc"
                 else commit_scan_bound(tab, res[3]))
        B, M = tab["rank"].shape
        row = {"kernel": name, "n": n, "topo": topo, "jobs": n_jobs,
               "B": B, "M": M, "N": tab["n_nodes"],
               "R": tab["u_tab"].shape[1], "L": tab["s_rank"].shape[1],
               **verdict, "ms": ms, "wrapper_ms": wrapper_ms,
               "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound[0],
               "bound_by": bound[1], "bytes": bound[2], "flops": bound[3]}
        step = ""
        if name == "commit_scan":  # B steps, one a row of the job bucket
            row["us_per_step"] = ms * 1e3 / B
            step = (f"us_per_step={row['us_per_step']:.3f} deterministic="
                    f"{verdict['deterministic']} ")
        log(f"[kernel] {name} n={n} {topo:6s} B={B} M={M} N={row['N']} "
            f"L={row['L']} bitwise={not verdict['mismatched']} "
            f"pay_ulps={verdict['pay_ulps']} kernel_ms={ms:.4f} "
            f"wrapper_ms={wrapper_ms:.4f} plain_ms={plain_ms:.4f} {step}"
            f"bound_ms={bound[0]:.5f} ({bound[1]})")
        rows.append(row)
    return rows


def extra_tables(kind: str, arg) -> dict:
    """The K5 tables of one of ``EXTRA_K5``; "cut": ``random_tables`` with
    0.5 added to every key's free, so that every window is cut at the last
    unit and a node row can be feasible with fewer than W units in windows
    (free 1.5 over one unit, or 0.5 over none once a unit is taken)."""
    if kind == "frac":
        return frac_tables(arg)
    if kind == "hadare":
        return hadare_tables(arg)[1]
    tab = random_tables(0, arg)
    if kind == "cut":
        tab["free"] = tab["free"] + 0.5
    return tab


def random_tables(seed: int, n_nodes: int, jobs: int = 512, R: int = 4,
                  C: int = 4, wmax: int = 8) -> dict:
    """Seeded K5 tables whose pools lie in random order over a sparse
    carry: ``n_nodes`` node rows with 1-4 of R types each (a key per
    node and type, C units, one free: gamma = C - 1), gangs of 1-8,
    1-R usable types in random preference order, a fifth of the jobs
    single-node, and a twentieth (drawn from seed + 1) asking for no unit:
    their empty spread slot is a candidate, also once no unit is left.  A
    pool in price order ends in a job's unusable units, so the fig5 walks
    end early (by entry 1020 of 1272 at n=2048 bursty); here the W-th
    eligible unit lies anywhere, and as the free units run out walks reach
    the pool's last, partial chunk and go several chunks deep.  The tables
    keep ``scan_tables``' invariants (the pool is the whole (key, unit)
    table; s_rank = rank[s_m], s_node = node_row[s_m])."""
    import numpy as np
    rs = np.random.RandomState(seed)
    has = rs.rand(n_nodes, R) < 0.7
    has[np.arange(n_nodes), rs.randint(0, R, n_nodes)] = True
    node_row, ktype = np.nonzero(has)
    M = len(node_row)
    P_tab = np.cumsum(rs.uniform(0.5, 1.5, (M, C)), axis=1)
    Kj = rs.randint(1, R + 1, jobs).astype(np.int32)
    rank_t = np.full((jobs, R), R, dtype=np.int32)
    for p in range(jobs):
        rank_t[p, rs.permutation(R)[:Kj[p]]] = np.arange(Kj[p])
    rank = np.ascontiguousarray(rank_t[:, ktype])
    u_tab = np.sort(rs.uniform(1.0, 30.0, (jobs, R)), axis=1)[:, ::-1]
    u_tab = np.where(np.arange(R)[None] < Kj[:, None], u_tab, 0.0)
    order = np.argsort(rs.rand(jobs, M * C), axis=1, kind="stable")
    s_m = (order // C).astype(np.int32)
    W = rs.randint(1, wmax + 1, jobs).astype(float)
    W[np.random.RandomState(seed + 1).rand(jobs) < 0.05] = 0.0
    return {"free": np.ones(M), "gamma": np.full(M, C - 1, dtype=np.int32),
            "P_tab": P_tab, "node_row": node_row.astype(np.int32),
            "W": W, "Kj": Kj,
            "single": rs.rand(jobs) < 0.2, "rank": rank, "u_tab": u_tab,
            "s_m": s_m, "s_u": (order % C).astype(np.int32),
            "s_rank": np.take_along_axis(rank, s_m, axis=1),
            "s_price": P_tab.reshape(-1)[order],
            "s_node": node_row[s_m].astype(np.int32), "n_nodes": n_nodes,
            "wmax": wmax, "C": C}


def extra_case(kind: str, arg) -> dict:
    """K5 on ``extra_tables(kind, arg)``, checked as ``sched_case`` checks
    it (raises on a difference); not timed."""
    tab = extra_tables(kind, arg)
    verdict = commit_scan_check(tab)[0]
    if not verdict["ok"]:
        raise RuntimeError(f"commit_scan disagrees with its plain version "
                           f"on the {kind} tables ({arg}): {verdict}")
    log(f"[kernel] commit_scan {kind} {arg:+} B={len(tab['W'])} "
        f"M={len(tab['free'])} L={tab['s_m'].shape[1]}: bitwise="
        f"{not verdict['mismatched']} pay_ulps={verdict['pay_ulps']} "
        f"deterministic={verdict['deterministic']}")
    return {"kernel": "commit_scan", "case": [kind, arg], **verdict}


def k4_tables(kind: str, n: int, seed: int = 0) -> dict:
    """The host tables of one K4 launch, built by
    ``batch_solver.pricing_tables`` on a ``PriceState`` of the round, for
    one of ``EXTRA_K4`` (``n`` jobs, draws from ``seed``):

    - "busy": the fig5 grown round with units taken, drawn key by key
      (free down, gamma up by the same units, as the greedy commit's waves
      take them): all of the fastest type's (v100), 60% of p100's, 20% of
      k80's.  The fast types' remaining units are then dearer than the
      slow types' and sort behind them, so walks go several chunks deep,
      and prefixes without W units of their types walk the whole pool;
    - "wide": the fig5 grown round with gangs of 16-128 (wmax 128, NumPy's
      eight running sums with a remainder), every unit free: at n = 200
      (25 node rows, L = 100) the largest gangs choose units of the pool's
      partial last chunk, and those of more than 100 walk all of it;
    - "mixed": the philly trace at t=0 on a 5-pod ``multi_cluster`` of five
      types, half of each pod's 13 nodes mixed (N = 65, two keys on a mixed
      node), three quarters of the jobs restricted to 1-4 of the types, a
      fifth single-node, units taken as in "busy" (all of v100's, 90% of
      p100's, 50% of k80's, 20% of t4's, 95% of rtx3090's) and 0.5 more
      from every third key that keeps a unit (fractional free units);
    - "queue": n jobs of the philly trace at t=0 on the fig5 grown cluster
      of 256 jobs (32 nodes), three quarters restricted to 1-2 of the
      types as in "mixed" (so a key's rank, and the cell it fills, differ
      from job to job): at n = 8192 more jobs than the card holds warps of
      K4 at once, so most jobs' blocks start in shared memory that another
      job's block has just left.

    The taken units are drawn from ``seed + 1``, so the state is the same
    whatever ``n``.  "hadare": the tables of the first greedy consult of
    phase hadare (``hadare_tables``)."""
    import numpy as np
    from repro_torch.core import batch_solver as bs
    from repro_torch.core.pricing import PriceState
    from repro_torch.core.trace import grown_cluster, multi_cluster, \
        philly_trace
    from repro_torch.core.utility import effective_throughput as util
    if kind == "hadare":
        return hadare_tables(n)[0]
    rs = np.random.RandomState(seed)
    if kind in ("mixed", "queue"):
        cluster = (multi_cluster(n_pods=5, nodes_per_pod=13, gpus_per_node=4,
                                 mixed_frac=0.5, seed=3) if kind == "mixed"
                   else grown_cluster(256))
        types = cluster.gpu_types
        jobs, now = philly_trace(n_jobs=n, seed=4, types=types), 0.0
        for j in jobs:
            if rs.rand() < 0.75:
                keep = set(rs.permutation(types)[:rs.randint(1, len(types))])
                j.throughput = {r: x for r, x in j.throughput.items()
                                if r in keep}
            j.single_node = kind == "mixed" and bool(rs.rand() < 0.2)
    else:
        jobs, cluster, now = fig5_round(n, "grown")
        if kind == "wide":
            for j in jobs:
                j.n_workers = int(rs.randint(16, 129))
    queue = sorted([j for j in jobs if j.arrival <= now],
                   key=lambda j: (j.arrival, j.job_id))
    ps = PriceState(cluster, queue, HORIZON, util, now)
    avail, gamma = ps.free_arr.copy(), ps.gamma_arr.copy()
    if kind in ("busy", "mixed"):  # the same state whatever n
        share = np.array([1.0, 0.6, 0.2] if kind == "busy"
                         else [1.0, 0.9, 0.5, 0.2, 0.95])[ps.type_col]
        taken = np.random.RandomState(seed + 1).binomial(
            avail.astype(np.int64), share)
        avail -= taken
        gamma += taken
    if kind == "mixed":
        keys = np.arange(0, len(avail), 3)
        avail[keys[avail[keys] >= 1.0]] -= 0.5
    return bs.pricing_tables(queue, avail, gamma, ps, now, util,
                             bs.bucket_size(len(queue)))


@functools.lru_cache(maxsize=1)
def hadare_tables(n: int, device=None) -> tuple:
    """The host tables of K4's and K5's first launches in phase hadare's
    run (``simulate_hadare`` of the fig5 trace of ``n`` parents on its
    grown cluster under FAULT_MODEL, ``HadarScheduler(solver="cuda")``):
    its first consult, every parent's single-node copies queued at t=0, a
    parent's copies in equal rows.  The run stops once both are built.
    ``device``: the scheduler's (the card by default; the CPU tests pass
    "cpu", where the kernels' plain versions run)."""
    from repro_torch.core import batch_solver as bs
    from repro_torch.core.hadar import HadarScheduler
    from repro_torch.sim.adapters import simulate_hadare
    from repro_torch.sim.faults import FailureModel
    got = {}

    class Built(Exception):
        pass

    def keep(name, real):
        def build(*a, **kw):
            tab = real(*a, **kw)
            # a copy: the tables alias the free vector the commit updates
            got.setdefault(name, copy.deepcopy(tab))
            if len(got) == 2:
                raise Built
            return tab
        return build
    jobs, cluster, _ = fig5_round(n, "grown")
    with mock.patch.object(bs, "pricing_tables",
                           keep("k4", bs.pricing_tables)), \
            mock.patch.object(bs, "scan_tables", keep("k5", bs.scan_tables)):
        try:
            simulate_hadare(jobs, cluster, scheduler=HadarScheduler(
                solver="cuda", device=device),
                faults=FailureModel(**FAULT_MODEL))
        except Built:
            pass
    if len(got) < 2:
        raise RuntimeError(f"hadare tables: the run built only {list(got)}")
    return got["k4"], got["k5"]


def k4_case(kind: str, n: int) -> dict:
    """K4 on ``k4_tables(kind, n)``, checked as ``sched_case`` checks it
    (raises on a difference); not timed.  Logs how deep the walks go."""
    tab = k4_tables(kind, n)
    verdict = find_alloc_check(tab)[0]
    if not verdict["ok"]:
        raise RuntimeError(f"find_alloc disagrees with its plain version "
                           f"on the {kind} tables (n={n}): {verdict}")
    walks = walk_stats(tab)
    B, M = tab["rank"].shape
    log(f"[kernel] find_alloc {kind} n={n} B={B} M={M} N={tab['n_nodes']} "
        f"R={tab['u_tab'].shape[1]} L={tab['s_rank'].shape[1]} wmax="
        f"{tab['wmax']}: bitwise={not verdict['mismatched']} "
        f"deterministic={verdict['deterministic']} walks {walks}")
    return {"kernel": "find_alloc", "case": [kind, n], **verdict, **walks}


def numpy_sum_check(seed: int) -> int:
    """The kernels replicate NumPy's pairwise float64 sum
    (``ref.pairwise_sum``); check that the NumPy running this script
    sums in that order, on 2000 random rows of 1-128 values.  Returns
    the number of rows checked; raises on a difference."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    rs = np.random.RandomState(seed)
    v = rs.uniform(0, 1, (2000, 128)) * 10.0 ** rs.uniform(-3, 3, (2000, 128))
    n = rs.randint(1, 129, 2000)
    got = ref.pairwise_sum(torch.from_numpy(v), torch.from_numpy(n)).numpy()
    want = np.array([v[i, :n[i]].sum() for i in range(len(n))])
    if not np.array_equal(got, want):
        raise RuntimeError("NumPy does not sum float64 in the order the "
                           "scheduler kernels replicate")
    return len(n)


def phase_kernel(seed: int):
    """Every kernel's cases; returns (rows, {kernel name: its main-path
    row})."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rows = [kernel_case(case, gen) for case in kernel_cases()]
    rwkv_rows = [rwkv_case(case, gen) for case in rwkv_cases()]
    rms_rows = [rms_case(case, gen) for case in RMS_CASES]
    log(f"[kernel] numpy float64 sum order checked on "
        f"{numpy_sum_check(seed)} rows")
    sched_rows = [row for n in SCHED_SIZES for topo in ("grown", "bursty")
                  for row in sched_case(n, topo)]
    sched_rows += [k4_case(*case) for case in EXTRA_K4]
    sched_rows += [extra_case(*case) for case in EXTRA_K5]
    main = {"flash_attention": next(r for r in rows if r["model_layout"]),
            "rwkv6_scan": next(r for r in rwkv_rows if r["kind"] == "main"),
            "rmsnorm": next(r for r in rms_rows if r["kind"] == "main")}
    for name in ("find_alloc", "commit_scan"):
        main[name] = next(r for r in sched_rows if r["kernel"] == name and
                          (r["n"], r["topo"]) == SCHED_MAIN)
    return rows + rwkv_rows + rms_rows + sched_rows, main


# ---------------------------------------------------------------------------
# prefill helpers
# ---------------------------------------------------------------------------

def _top1(a, b) -> float:
    return float((a.argmax(-1) == b.argmax(-1)).float().mean())


def _depth_agreement(model, cfg, tokens, depth: int) -> dict:
    """Kernel path vs einsum path, forward through the first ``depth``
    layers only: top-1 agreement and max |logit difference|."""
    from types import SimpleNamespace
    from repro_torch.models.model import forward
    part = SimpleNamespace(**dict(model.named_parameters(recurse=False)),
                           blocks=model.blocks[:depth])
    cfg = dataclasses.replace(cfg, n_layers=depth)
    lk, _ = forward(part, dataclasses.replace(cfg, attn_impl="pallas"),
                    {"tokens": tokens})
    lx, _ = forward(part, dataclasses.replace(cfg, attn_impl="xla"),
                    {"tokens": tokens})
    return {"depth": depth, "top1": _top1(lk, lx),
            "max_abs_logit_diff": float((lk.float() - lx.float()).abs().max())}


def _layerwise(model, cfg, tokens, check) -> dict:
    """Every layer on the same input (the plain path's output of the layer
    before), so that nothing compounds across layers:

    - ``block_rel_diff``: the layer through both paths, max |difference|
      over max |output|;
    - ``kernel``: ``check(blk, x, positions, cfg)``, the kernel on the
      layer's own inputs against its plain version."""
    import torch
    from repro_torch.models.blocks import block_fwd
    win = cfg.sliding_window
    fk = block_fwd(dataclasses.replace(cfg, attn_impl="pallas"), win)
    fx = block_fwd(dataclasses.replace(cfg, attn_impl="xla"), win)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = model.embed[tokens]
    res = {"block_rel_diff": [], "kernel": []}
    for blk in model.blocks:
        res["kernel"].append(check(blk, x, positions, cfg))
        yk, _ = fk(blk, x, positions)
        yx, _ = fx(blk, x, positions)
        res["block_rel_diff"].append(float(
            (yk.float() - yx.float()).abs().max() / yx.float().abs().max()))
        x = yx
    return res


def _attention_check(blk, x, positions, cfg) -> dict:
    """K1 on a llama layer's own q, k, v (the model's score scale), called
    as ``forward`` calls it (``ops.flash_attention``, model layout in and
    out), against its plain version, by ``gate``."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import apply_rope, rmsnorm
    win = cfg.sliding_window
    q, k, v = attn.qkv(blk, rmsnorm(x, blk.ln1, cfg.norm_eps))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, window=win)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    return gate(out.transpose(1, 2),
                ref.flash_attention_ref(q, k, v, True, win), cfg.dtype)


def _scan_check(blk, x, positions, cfg) -> dict:
    """K2 on an rwkv6 layer's own r, k, v, w, u from a zero state (as
    ``forward`` calls it) against its plain version, by ``gate`` and
    ``state_gate``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as rk
    from repro_torch.models import rwkv
    from repro_torch.models.layers import rmsnorm
    B, _, d = x.shape
    zshift = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
    zstate = torch.zeros((B, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                         device=x.device)
    h = rmsnorm(x, blk.ln1, cfg.norm_eps)
    r, k, v, w, _ = rwkv.time_mix_inputs(blk, h, cfg, zshift)
    args = [t.transpose(1, 2) for t in (r, k, v, w)] + [blk.u, zstate]
    out, s = rk.rwkv6_scan(*args)
    want, want_s = ref.rwkv6_scan_ref(*args)
    return state_gate(gate(out, want, cfg.dtype), s, want_s)


def _counters():
    from repro_torch.kernels import (commit_scan, find_alloc, flash_attention,
                                     rmsnorm, rwkv6_scan)
    return {"flash_attention": flash_attention, "rwkv6_scan": rwkv6_scan,
            "rmsnorm": rmsnorm, "find_alloc": find_alloc,
            "commit_scan": commit_scan}


def zero_launches():
    for mod in _counters().values():
        mod.LAUNCHES = 0


def read_launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in _counters().items()}


def _check_launches(phase: str, got: dict, want: dict):
    if got != want:
        raise RuntimeError(f"{phase}: kernel launches {got}, want {want}")


def _forward_timed(model, cfg, tokens, want: dict):
    """``FORWARD_REPS`` warmed-up ``forward`` calls, each timed on the
    host's clock, with every launch count set to 0 just before it and read
    just after (the main path's runs when ``cfg.attn_impl`` is "pallas");
    each run's counts must equal ``want``.  Returns (the last logits, the
    median wall time, the counts, every wall time): one call's wall time
    swings by a tenth or more with the host."""
    import torch
    from repro_torch.models.model import forward
    forward(model, cfg, {"tokens": tokens})  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    walls = []
    for _ in range(FORWARD_REPS):
        zero_launches()  # the run starts here
        t0 = time.perf_counter()
        logits, _ = forward(model, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = read_launches()  # ... and ends here
        _check_launches(f"{cfg.name} forward ({cfg.attn_impl})", launches,
                        want)
    return logits, statistics.median(walls), launches, walls


def _check_logits(name, lg, shape):
    import torch
    if tuple(lg.shape) != shape or not bool(torch.isfinite(lg).all()):
        raise RuntimeError(f"{name} logits: shape {tuple(lg.shape)} or "
                           f"non-finite values")


# ---------------------------------------------------------------------------
# phases 2 and 4: prefill
# ---------------------------------------------------------------------------

# Each block normalises twice (ln1 before attention or the time mix, ln2
# before the MLP or the channel mix: models/blocks.py ``block_fwd``) and
# ``forward`` once more (the final norm: models/model.py).
NORMS_PER_BLOCK = 2


def norms_per_forward(cfg) -> int:
    return NORMS_PER_BLOCK * cfg.n_layers + 1


def _norm_times(model, rows: int, d: int) -> dict:
    """K3 and the plain norm on a (rows, d) bf16 hidden state with the
    model's final-norm weights (the shape of every norm of the forward)."""
    import torch
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.models.layers import rmsnorm as plain_norm
    x = torch.randn((rows, d), device="cuda").to(model.final_norm.dtype)
    w = model.final_norm
    return {"shape": [rows, d],
            "ms": device_ms(lambda: rk.rmsnorm(x, w, 1e-5), 50),
            "plain_ms": cuda_ms(lambda: plain_norm(x, w, 1e-5), 50)}


# Per model path: its kernel (one launch per layer of a kernel-path
# ``forward``) and the per-layer check of it, the float32 model's depth
# (None: full) and the depths at which its two paths are compared.
PREFILL = {
    "llama3.2-1b": {"kernel": "flash_attention", "check": _attention_check,
                    "f32_layers": None, "depths": (1, 2, 4, 8, 16)},
    "rwkv6-7b": {"kernel": "rwkv6_scan", "check": _scan_check,
                 "f32_layers": 2, "depths": (1, 2)},
}


def phase_prefill(seed: int, arch: str):
    """``forward`` on 4 x 1024 tokens: bf16 at full depth through the
    kernel and the plain path, then the same draws in float32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    from repro_torch.models.layers import rmsnorm as plain_norm
    from repro_torch.models.model import init_params
    spec = PREFILL[arch]
    base = get_config(arch)
    B, S = 4, 1024
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    tokens = torch.randint(0, base.vocab_size, (B, S), generator=gen,
                           device="cuda")
    res = {"arch": arch, "batch": B, "seq": S}

    # bf16, full depth: the main path
    cfg_k = dataclasses.replace(base, attn_impl="pallas")
    cfg_x = dataclasses.replace(base, attn_impl="xla")
    model = init_params(base, seed, device="cuda")
    res["params"] = sum(p.numel() for p in model.parameters())
    none = {name: 0 for name in _counters()}
    norms = norms_per_forward(base)
    log(f"[prefill] {arch}: the kernel path must launch "
        f"{spec['kernel']} {base.n_layers} times (one per layer) and "
        f"rmsnorm {norms} times ({NORMS_PER_BLOCK} per layer + the final "
        f"norm) per forward; the plain path none")
    logits_k, wall_k, launches, walls_k = _forward_timed(
        model, cfg_k, tokens,
        {**none, spec["kernel"]: base.n_layers, "rmsnorm": norms})
    logits_x, wall_x, _, _ = _forward_timed(model, cfg_x, tokens, none)
    # the kernel path with the plain norm in place of K3: what K3 saves
    with mock.patch.object(blocks, "norm_fn", lambda cfg: plain_norm):
        _, wall_p, _, _ = _forward_timed(model, cfg_k, tokens,
                                      {**none, spec["kernel"]: base.n_layers})
    for name, lg in (("bf16 pallas", logits_k), ("bf16 xla", logits_x)):
        _check_logits(name, lg, (*tokens.shape, base.vocab_size))
    res.update(launches=launches,
               bf16_max_abs_logit_diff=float(
                   (logits_k.float() - logits_x.float()).abs().max()),
               bf16_top1_agreement=_top1(logits_k, logits_x),
               bf16_pallas_tok_per_s=B * S / wall_k,
               bf16_xla_tok_per_s=B * S / wall_x,
               bf16_pallas_wall_s=wall_k, bf16_pallas_wall_s_runs=walls_k,
               bf16_xla_wall_s=wall_x,
               bf16_pallas_plain_norm_wall_s=wall_p,
               rmsnorm=_norm_times(model, B * S, base.d_model))
    log(f"[prefill] {arch}: launches per kernel-path forward {launches}")
    del logits_k, logits_x
    res["bf16_layerwise"] = _layerwise(model, base, tokens, spec["check"])
    res["bf16_depth_1"] = _depth_agreement(model, base, tokens, 1)
    del model
    torch.cuda.empty_cache()

    # The same draws in float32 (a cut model draws the same first layers),
    # where the two paths differ only by the order of f32 sums.  With the
    # random llama init (attention scores of std ~128, near-argmax softmax)
    # a difference that small still compounds over the layers, so
    # agreement is read against depth and per layer.
    cfg32 = dataclasses.replace(base, dtype="float32",
                                n_layers=spec["f32_layers"] or base.n_layers)
    model32 = init_params(cfg32, seed, device="cuda")
    res["f32_depth"] = [_depth_agreement(model32, cfg32, tokens, n)
                        for n in spec["depths"]]
    res["f32_layerwise"] = _layerwise(model32, cfg32, tokens, spec["check"])
    del model32
    torch.cuda.empty_cache()
    log("[prefill] " + json.dumps(res))
    one = res["f32_depth"][0]["top1"]
    if not one >= 0.99:
        raise RuntimeError(f"{arch} float32, one layer: kernel and plain "
                           f"paths agree on top-1 at {one:.4f} of "
                           f"positions, want >= 0.99")
    worst = max(res["f32_layerwise"]["block_rel_diff"])
    if not worst < 2e-4:
        raise RuntimeError(f"{arch} float32 layer outputs of the kernel and "
                           f"plain paths differ by {worst:.3g} of their "
                           f"largest value, want < 2e-4")
    for dt in ("bf16", "f32"):
        for i, g in enumerate(res[f"{dt}_layerwise"]["kernel"]):
            if not g["ok"]:
                raise RuntimeError(
                    f"{arch} {dt} layer {i}: {spec['kernel']} disagrees "
                    f"with its plain version: {g['gated_on']} "
                    f"{g[g['gated_on']]} (limit {g['tol']}), state "
                    f"{g.get('state_abs_err')}, {g.get('state_rel_err')} "
                    f"of its largest value")
    return res


# ---------------------------------------------------------------------------
# phases 3 and 5: serve
# ---------------------------------------------------------------------------

def phase_serve(seed: int, arch: str):
    """8 requests of 32-96 prompt tokens, 32 new tokens each, on 4 slots.
    The engine prefills and decodes through ``decode_step``, which
    launches no kernel (as in the JAX package); every count must read 0."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.serve_step import Request, ServingEngine
    cfg = get_config(arch)
    model = init_params(cfg, seed, device="cuda")
    eng = ServingEngine(cfg, model, slots=4, max_seq=256, device="cuda")
    rs = np.random.RandomState(seed)
    reqs = [Request(i, rs.randint(0, cfg.vocab_size, size=rs.randint(32, 97)),
                    32) for i in range(8)]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    wall = time.perf_counter() - t0  # run() returns host arrays
    launches = read_launches()
    new = sum(len(r.out) for r in done)
    if len(done) != 8 or any(
            len(r.out) != 32 or r.out.min() < 0
            or r.out.max() >= cfg.vocab_size for r in done):
        raise RuntimeError(f"serve {arch}: a request did not complete with "
                           f"32 valid tokens")
    res = {"arch": arch, "requests": len(done), "prompt_tokens": int(sum(
               len(r.prompt) for r in reqs)), "new_tokens": new,
           "wall_s": wall, "tok_per_s": new / wall,
           "kernel_launches": launches}
    log("[serve] " + json.dumps(res))
    _check_launches(f"serve {arch}", launches,
                    {name: 0 for name in launches})
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 6 and 7: the Hadar decision path
# ---------------------------------------------------------------------------

def _decisions(sched, out) -> dict:
    """job -> (allocation, cost, payoff, rate) of one consultation."""
    return {jid: (sorted(alloc.items()),) + (
        (c.cost, c.payoff, c.rate) if (c := sched.last_decisions.get(jid))
        else ()) for jid, alloc in out.items()}


def phase_schedule():
    """One ``HadarScheduler.schedule`` round of the fig5 shape per size
    and topology, with ``solver="cuda"`` and ``solver="numpy"``: the
    decisions must be identical, the cuda round must launch K4 and K5
    (at the sizes of SCHED_SIZES) and the numpy round no kernel.  The
    seconds per round of both are the sweep that calibrates ``auto``."""
    import torch
    from repro_torch.core.hadar import HadarScheduler
    from repro_torch.core.types import clone_jobs
    jobs, cluster, now = fig5_round(SCHED_SIZES[0], "grown")
    HadarScheduler(solver="cuda").schedule(now, 360.0, clone_jobs(jobs),
                                           cluster)  # warm-up
    rows = []
    for n in SWEEP_SIZES:
        for topo in ("grown", "bursty"):
            jobs, cluster, now = fig5_round(n, topo)
            res = {}
            for solver in ("cuda", "numpy"):
                sched = HadarScheduler(solver=solver)
                torch.cuda.synchronize()
                zero_launches()
                out = sched.schedule(now, 360.0, clone_jobs(jobs), cluster)
                res[solver] = (_decisions(sched, out),
                               sched.last_sched_seconds, read_launches())
            row = {"n": n, "topo": topo, "nodes": len(cluster.nodes),
                   "gpus": cluster.total_gpus(),
                   "decisions": len(res["numpy"][0]),
                   "identical": res["cuda"][0] == res["numpy"][0],
                   "cuda_s": res["cuda"][1], "numpy_s": res["numpy"][1],
                   "cuda_launches": res["cuda"][2],
                   "numpy_launches": res["numpy"][2]}
            log("[schedule] " + json.dumps(row))
            rows.append(row)
            if not row["identical"]:
                raise RuntimeError(f"schedule n={n} {topo}: the cuda and "
                                   f"numpy solvers decide differently")
            if any(row["numpy_launches"].values()):
                raise RuntimeError(f"schedule n={n} {topo}: the numpy "
                                   f"solver launched {row['numpy_launches']}")
            if n in SCHED_SIZES and not (
                    row["cuda_launches"]["find_alloc"]
                    and row["cuda_launches"]["commit_scan"]):
                raise RuntimeError(f"schedule n={n} {topo}: the cuda solver "
                                   f"launched {row['cuda_launches']}, want "
                                   f"find_alloc and commit_scan")
    return rows


def _recorded(real, log: list, table: int):
    """A kernel's ``launch`` that also notes each launch's (B, R), the
    shape of its utility table, input ``table``."""
    def launch(ins, out, *kw):
        real(ins, out, *kw)
        log.append(tuple(ins[table].shape))
    return launch


def _device_ms(prof) -> dict:
    """From a ``torch.profiler`` trace: the device time (ms) of K4's and
    K5's launches, and of all the device's work (kernels and copies)."""
    import torch
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = {"k4_ms": 0.0, "k5_ms": 0.0,
          "device_ms": sum(e.time_range.elapsed_us() for e in dev) / 1e3}
    for key, part in (("k4_ms", "find_alloc"), ("k5_ms", "commit_scan")):
        ms[key] = sum(e.time_range.elapsed_us() for e in dev
                      if part in e.name) / 1e3
    return ms


def run_sim(engine: str, solver: str, jobs, cluster, faults=None,
            profile: bool = False, **kw) -> dict:
    """One run of ``simulate_rounds``, ``simulate_events`` or HadarE's
    ``simulate_hadare`` (``engine`` "rounds", "events", "hadare") with
    ``HadarScheduler(solver)``, the launch counts set to 0 just before it
    and read just after; ``kw`` goes to the engine.  Also notes each K4
    and K5 launch's job bucket B and type count R, and how many
    ``PriceState``s the scheduler built; for "hadare", each consult's
    decision keys in order as the scheduler returned them and after
    sibling dedupe (``keys``), and the longest queue of copies.  ``profile``: trace the run with ``torch.profiler`` and report
    the device time of K4, K5 and all the device's work
    (``_device_ms``)."""
    import contextlib
    from collections import Counter
    import torch
    from torch.profiler import ProfilerActivity
    from repro_torch.core import hadar, hadare
    from repro_torch.core.types import clone_jobs
    from repro_torch.kernels import commit_scan as ck
    from repro_torch.kernels import find_alloc as fk
    from repro_torch.sim import adapters
    from repro_torch.sim import engine as eng
    from repro_torch.sim.metrics import result_fields
    builds = [0]

    class Counted(hadar.PriceState):
        def __init__(self, *a, **kw):
            builds[0] += 1
            super().__init__(*a, **kw)
    k4, k5 = [], []
    jobs = clone_jobs(jobs)
    sched = hadar.HadarScheduler(solver=solver)
    raw, kept, queue = [], [], [0]
    if engine == "hadare":
        real_schedule, real_dedupe = sched.schedule, hadare._dedupe_siblings

        def schedule(now, round_len, live, view):
            out = real_schedule(now, round_len, live, view)
            raw.append(list(out))
            queue[0] = max(queue[0], len(live))
            return out

        def dedupe(*a):
            out = real_dedupe(*a)
            kept.append(list(out))
            return out
        sched.schedule = schedule
        dedupe_patch = mock.patch.object(hadare, "_dedupe_siblings", dedupe)

        def go():
            return adapters.simulate_hadare(jobs, cluster, scheduler=sched,
                                            faults=faults, **kw)
    else:
        dedupe_patch = contextlib.nullcontext()

        def go():
            return getattr(eng, f"simulate_{engine}")(
                sched, jobs, cluster, faults=faults, **kw)
    prof = (torch.profiler.profile(activities=[ProfilerActivity.CUDA])
            if profile else contextlib.nullcontext())
    with mock.patch.object(hadar, "PriceState", Counted), dedupe_patch, \
            mock.patch.object(fk, "launch", _recorded(fk.launch, k4, 7)), \
            mock.patch.object(ck, "launch", _recorded(ck.launch, k5, 8)):
        torch.cuda.synchronize()
        zero_launches()
        with prof:
            t0 = time.perf_counter()
            res = go()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_launches()
    consults = [r.sched_seconds for r in res.rounds if r.sched_seconds > 0]
    out = {"res": res, "fields": result_fields(res), "wall_s": wall,
           "consults": getattr(res, "sched_calls", len(consults)),
           "sched_s": sum(consults), "launches": launches,
           "price_states": builds[0],
           "k4_B": dict(sorted(Counter(b for b, _ in k4).items())),
           "k4_R": sorted({r for _, r in k4}),
           "k5_B": dict(sorted(Counter(b for b, _ in k5).items())),
           "k5_R": sorted({r for _, r in k5})}
    if engine == "hadare":
        out.update(keys=(raw, kept), largest_queue=queue[0])
    if profile:
        out.update(_device_ms(prof))
        out["device_share"] = out["device_ms"] / 1e3 / wall
        steps = sum(b for b, _ in k5)   # K5 takes a step a bucket row
        if steps:
            out["k5_us_per_step"] = out["k5_ms"] * 1e3 / steps
    return out


def _check_pair(phase: str, runs: dict, k5: bool = True):
    """The cuda and numpy runs of one path: every result field but the
    host time equal, and the kernels launched by the cuda run only (K5
    too where ``k5``)."""
    if runs["cuda"]["fields"] != runs["numpy"]["fields"]:
        raise RuntimeError(f"{phase}: the cuda and numpy solvers give "
                           f"different results")
    got = runs["cuda"]["launches"]
    if any(runs["numpy"]["launches"].values()) or not got["find_alloc"] \
            or (k5 and not got["commit_scan"]):
        raise RuntimeError(f"{phase}: launches cuda {got}, numpy "
                           f"{runs['numpy']['launches']}")


def _check_reference(phase: str, res, want: dict, counts: dict):
    """``res`` against the JAX package's run of the same path: the counts
    exactly, average JCT and makespan within REF_REL_TOL."""
    for key, value in counts.items():
        if value != want[key]:
            raise RuntimeError(f"{phase}: {key} {value}, the JAX package "
                               f"{want[key]}")
    for key, value in (("avg_jct_s", res.avg_jct()),
                       ("makespan_s", res.total_seconds)):
        if abs(value - want[key]) > REF_REL_TOL * abs(want[key]):
            raise RuntimeError(f"{phase}: {key} {value!r}, the JAX package "
                               f"{want[key]!r}")


def _summary(runs: dict) -> dict:
    out = {}
    for solver, run in runs.items():
        res = run["res"]
        out[solver] = {k: v for k, v in run.items()
                       if k not in ("res", "fields", "keys")}
        out[solver].update(avg_jct_s=res.avg_jct(),
                           makespan_s=res.total_seconds,
                           evictions=res.evictions,
                           lost_gpu_s=res.gpu_seconds_lost,
                           records=len(res.rounds),
                           s_per_consult=run["sched_s"] / max(
                               1, run["consults"]))
    return out


def phase_simulate():
    """``simulate`` of the fig5 trace of SIM_JOBS jobs on its grown
    cluster with ``solver="cuda"`` and ``"numpy"``, then the fig5 trace
    of FAULT_ROUND_JOBS jobs through ``simulate_rounds`` under
    FAULT_MODEL: every result field but host time equal; the cuda runs
    launch K4 and K5, the numpy runs no kernel; the faulted run's rounds,
    evictions, average JCT and makespan those of the JAX package
    (REF_ROUNDS_FAULTED)."""
    from repro_torch.sim.faults import FailureModel
    out = {}
    for name, n, faults in (("plain", SIM_JOBS, None),
                            ("faulted", FAULT_ROUND_JOBS,
                             FailureModel(**FAULT_MODEL))):
        jobs, cluster, _ = fig5_round(n, "grown")
        runs = {s: run_sim("rounds", s, jobs, cluster, faults)
                for s in ("cuda", "numpy")}
        out[name] = {"jobs": n, **_summary(runs)}
        log(f"[simulate] {name} " + json.dumps(out[name]))
        _check_pair(f"simulate {name}", runs)
        if faults is not None:
            res = runs["numpy"]["res"]
            _check_reference("simulate faulted", res, REF_ROUNDS_FAULTED, {
                "rounds": len(res.rounds), "evictions": res.evictions})
    return out


def phase_events():
    """``simulate_events`` of the fig5 trace of SIM_JOBS jobs on its grown
    cluster under FAULT_MODEL, with ``solver="cuda"`` and ``"numpy"``:
    every result field but host time equal (average JCT, makespan, each
    finish time, evictions, lost GPU-seconds, events, consults, each
    interval record); K4 and K5 launched by the cuda run only; the
    events, consults and evictions those of the JAX package, its average
    JCT and makespan within REF_REL_TOL (REF_EVENTS).  Reports each
    solver's wall and seconds a consult, K4's and K5's launches, K4's job
    buckets, the PriceStates built, and from ``torch.profiler``'s trace
    of the cuda run (device activity only) the device time of K4, K5 and
    all the device's work, and that work's share of that run's wall."""
    from repro_torch.sim.faults import FailureModel
    jobs, cluster, _ = fig5_round(SIM_JOBS, "grown")
    model = FailureModel(**FAULT_MODEL)
    runs = {s: run_sim("events", s, jobs, cluster, model,
                       profile=s == "cuda")
            for s in ("cuda", "numpy")}
    windows = model.sample(cluster)
    out = {"jobs": SIM_JOBS, "windows": len(windows),
           "spot_windows": sum(w.kind == "spot" for w in windows),
           **_summary(runs)}
    log("[events] " + json.dumps(out))
    _check_pair("events", runs)
    res = runs["numpy"]["res"]
    _check_reference("events", res, REF_EVENTS, {
        "n_events": res.n_events, "sched_calls": res.sched_calls,
        "evictions": res.evictions})
    return out


def phase_mini():
    """The type outage: philly_mini through both engines and both solvers
    on simulation_cluster(), under its fault CSV and under a hand-made
    trace that downs every K80 node together (the view's R drops to 2),
    and the 48-job fig5 trace through the event engine with the K80s
    down from t=0.  Each cuda run equal to its numpy run and launching
    K4; under the outage K4 (and on the 48-job trace K5) took R = 2."""
    from repro_torch.core.trace import philly_trace, simulation_cluster
    from repro_torch.sim.faults import FailureTrace
    from repro_torch.sim.replay import load_fault_csv, load_trace_csv
    cluster = simulation_cluster()
    mini = load_trace_csv(str(MINI_TRACE), types=cluster.gpu_types)
    wide = philly_trace(n_jobs=OUTAGE_JOBS, seed=1, types=cluster.gpu_types)
    outage = FailureTrace([(n, *K80_OUTAGE) for n in K80_NODES])
    cases = [(e, "csv", mini, load_fault_csv(str(MINI_FAULTS), cluster))
             for e in ("rounds", "events")]
    cases += [(e, "k80", mini, outage) for e in ("rounds", "events")]
    cases.append(("events", "k80 wide", wide, FailureTrace(
        [(n, 0.0, K80_OUTAGE[1]) for n in K80_NODES])))
    rows = []
    for engine, name, jobs, faults in cases:
        runs = {s: run_sim(engine, s, jobs, cluster, faults)
                for s in ("cuda", "numpy")}
        row = {"engine": engine, "faults": name, "jobs": len(jobs),
               **_summary(runs)}
        log("[mini] " + json.dumps(row))
        rows.append(row)
        phase = f"mini {engine} {name}"
        _check_pair(phase, runs, k5=name == "k80 wide")
        cuda = runs["cuda"]
        if name.startswith("k80") and (2 not in cuda["k4_R"] or (
                name == "k80 wide" and 2 not in cuda["k5_R"])):
            raise RuntimeError(f"{phase}: no launch took the view without "
                               f"K80 (K4 R {cuda['k4_R']}, K5 R "
                               f"{cuda['k5_R']})")
    return rows


def _check_keys(phase: str, runs: dict):
    """Each consult's decision keys, in order, before and after sibling
    dedupe, equal between the cuda and numpy runs."""
    raw, kept = runs["cuda"]["keys"]
    if (raw, kept) != runs["numpy"]["keys"]:
        bad = next((i for i, (a, b) in enumerate(zip(
            raw, runs["numpy"]["keys"][0])) if a != b), None)
        raise RuntimeError(f"{phase}: the cuda and numpy solvers' decision "
                           f"keys differ (first at consult {bad})")
    if not raw or len(raw) != len(kept):
        raise RuntimeError(f"{phase}: {len(raw)} consults, {len(kept)} "
                           f"dedupes")


def phase_hadare():
    """HadarE: ``simulate_hadare`` of the fig5 trace of HADARE_JOBS parents
    on its grown cluster under FAULT_MODEL, with ``solver="cuda"`` and
    ``"numpy"``: every result field but host time equal (average JCT,
    makespan, each parent's finish time, evictions, lost GPU-seconds,
    each round record), each consult's decision keys in order before and
    after sibling dedupe equal, K4 and K5 launched by the cuda run only;
    the rounds and evictions those of the JAX package, its average JCT and
    makespan within REF_REL_TOL (REF_HADARE).  Then every mix on the
    paper's physical clusters (``aws_cluster``, ``testbed_cluster``) at
    HADARE_ROUND, both solvers: equal, and each cuda run launches K4.
    Reports each solver's wall and seconds a consult, K4's and K5's
    launches and buckets, the PriceStates built, and from
    ``torch.profiler``'s trace of the cuda run (device activity only) the
    device time of K4, K5 and all the device's work, and its share of the
    wall."""
    from repro_torch.core.trace import MIXES, aws_cluster, mix_jobs, \
        testbed_cluster
    from repro_torch.sim.faults import FailureModel
    jobs, cluster, _ = fig5_round(HADARE_JOBS, "grown")
    runs = {s: run_sim("hadare", s, jobs, cluster,
                       FailureModel(**FAULT_MODEL), profile=s == "cuda")
            for s in ("cuda", "numpy")}
    res = runs["numpy"]["res"]
    out = {"jobs": HADARE_JOBS, "nodes": len(cluster.nodes),
           "finished": sum(p.finish_time is not None for p in res.jobs),
           **_summary(runs)}
    log("[hadare] " + json.dumps(out))
    _check_pair("hadare", runs)
    _check_keys("hadare", runs)
    _check_reference("hadare", res, REF_HADARE, {
        "rounds": len(res.rounds), "evictions": res.evictions})
    out["physical"] = []
    for make in (aws_cluster, testbed_cluster):
        cl = make()
        for mix in MIXES:
            runs = {s: run_sim("hadare", s, mix_jobs(mix, cl), cl,
                               round_len=HADARE_ROUND)
                    for s in ("cuda", "numpy")}
            row = {"cluster": make.__name__, "mix": mix,
                   "rounds": len(runs["numpy"]["res"].rounds),
                   "makespan_s": runs["numpy"]["res"].total_seconds,
                   **{f"{s}_{k}": runs[s][k] for s in runs
                      for k in ("wall_s", "consults", "launches")}}
            log("[hadare] " + json.dumps(row))
            phase = f"hadare {make.__name__} {mix}"
            _check_pair(phase, runs, k5=False)
            _check_keys(phase, runs)
            out["physical"].append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                log(f"[build] {line.strip()}")

    rows, main_rows = phase_kernel(args.seed)
    prefill = phase_prefill(args.seed, "llama3.2-1b")
    serve = phase_serve(args.seed, "llama3.2-1b")
    prefill_rwkv = phase_prefill(args.seed, "rwkv6-7b")
    serve_rwkv = phase_serve(args.seed, "rwkv6-7b")
    schedule = phase_schedule()
    sim = phase_simulate()
    events = phase_events()
    mini = phase_mini()
    hadare = phase_hadare()
    sched_main = next(r for r in schedule
                      if (r["n"], r["topo"]) == SCHED_MAIN)["cuda_launches"]

    # kernel -> (the TPU or JAX kernel it replaces, the main path's counts)
    paths = {"flash_attention": ("src/repro/kernels/flash_attention.py:65",
                                 prefill["launches"]),
             "rwkv6_scan": ("src/repro/kernels/rwkv6_scan.py:71",
                            prefill_rwkv["launches"]),
             "rmsnorm": ("src/repro/kernels/rmsnorm.py:18",
                         prefill["launches"]),
             "find_alloc": ("src/repro/core/batch_solver.py:228", sched_main),
             "commit_scan": ("src/repro/core/batch_solver.py:798",
                             sched_main)}
    kernels = [{"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": launches[name],
                **{k: main_rows[name][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
               for name, (replaces, launches) in paths.items()]
    kernels[-1]["us_per_step"] = main_rows["commit_scan"]["us_per_step"]
    for k in kernels[-2:]:
        k["event_run_launches"] = events["cuda"]["launches"][k["name"]]
        k["hadare_run_launches"] = hadare["cuda"]["launches"][k["name"]]
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "kernel_cases": rows,
                                   "prefill": prefill, "serve": serve,
                                   "prefill_rwkv": prefill_rwkv,
                                   "serve_rwkv": serve_rwkv,
                                   "schedule": schedule, "simulate": sim,
                                   "events": events, "mini": mini,
                                   "hadare": hadare,
                                   "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

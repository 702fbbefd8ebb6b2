#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (an H100 is the target).

    python3 chip_smoke.py [--seed N] [--out FILE.json]

Builds every hand-written kernel from ``src/repro_torch/kernels/csrc`` and
drives the port's paths with random weights and traces from ``--seed``:
llama3.2-1b and rwkv6-7b at full width and depth (flash attention K1, the
WKV6 scan K2, RMSNorm K3) and the Hadar decision path on the fig5 shape
(FIND_ALLOC K4, the greedy commit K5).  Any failure raises and the script
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
   plain version's, a spread payoff within one ulp (reported).  First the
   running NumPy is checked to sum float64 in the order both replicate.
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
7. simulate -- ``simulate`` of the 256-job fig5 trace with both solvers:
   average JCT, makespan and every finish time equal; K4 and K5 launched
   by the cuda run only.

Full-depth agreement of the two model paths is printed, not gated: the
random init makes a deep stack chaotic.  It prints a ``{"kernels":
[...]}`` line, the card's name and power limit, and last ``{"ok": true,
"device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
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
# the decision-latency sweep of the schedule phase (both solvers)
SWEEP_SIZES = (64, 256, 1024, 2048)
SIM_JOBS = 256
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
    ps = PriceState(cluster, queue, 7 * 24 * 3600.0, util, now)
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


def find_alloc_check(tab):
    """K4 on the card against its plain version on the same tables.
    Returns (verdict, args, the kernel's results)."""
    import torch
    from repro_torch.core import batch_solver as bs
    from repro_torch.core.dp import COMM_COST_FRAC
    from repro_torch.kernels import find_alloc as fk
    from repro_torch.kernels import ref
    args = bs._to(torch.device("cuda"),
                  *(tab[k] for k in bs.FIND_ALLOC_ARGS))
    kw = (tab["n_nodes"], COMM_COST_FRAC, tab["wmax"])
    out = fk.find_alloc(*args, *kw)
    torch.cuda.synchronize()
    want = ref.find_alloc_ref(*args, *kw)
    return _compare(out, want, FIND_ALLOC_OUT, ("sp_pay",)), args, out


def commit_scan_check(tab):
    """K5 on the card against its plain version on the same tables.
    Returns (verdict, args, the kernel's results, per-step pool reads of
    the plain version)."""
    import torch
    from repro_torch.core import batch_solver as bs
    from repro_torch.core.dp import COMM_COST_FRAC
    from repro_torch.kernels import commit_scan as ck
    from repro_torch.kernels import ref
    args = bs._to(torch.device("cuda"),
                  *(tab[k] for k in bs.COMMIT_SCAN_ARGS))
    kw = (tab["n_nodes"], COMM_COST_FRAC, tab["wmax"])
    out = ck.commit_scan(*args, *kw)
    torch.cuda.synchronize()
    need = []
    want = ref.commit_scan_ref(*args, *kw, need=need)
    return (_compare(out, want, COMMIT_SCAN_OUT, ("win2_pay",)), args, out,
            need)


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
    import numpy as np
    B, M = tab["rank"].shape
    R = tab["u_tab"].shape[1]
    N, L = tab["n_nodes"], tab["s_rank"].shape[1]
    W = tab["W"].astype(np.int64)
    walk = np.zeros(B, dtype=np.int64)
    chosen = 0
    for k in range(1, R + 1):
        elig = tab["s_valid"] & (tab["s_rank"] < k)
        cs = np.cumsum(elig, axis=1)
        total = cs[:, -1] if L else np.zeros(B, dtype=np.int64)
        reach = np.where(total >= W, np.argmax(cs >= W[:, None], axis=1) + 1,
                         L)
        reach = np.where((W == 0) | (tab["Kj"] == 0), 0, reach)
        walk = np.maximum(walk, reach)
        chosen += int(np.minimum(W, total).sum())
    nbytes = (tab["avail"].nbytes + tab["cumP"].nbytes
              + tab["node_row"].nbytes
              + B * (8 + 4 + 1 + M * 4 + R * 8)
              + int(walk.sum()) * 5 + chosen * 12
              + B * N * (1 + 4 + 4 + 8 + 8 + R * 8)
              + B * R * (1 + 8 + 4 + 4 + M * 4))
    flops = B * N * R * 6 + chosen * 2
    return _time_bound(nbytes, flops) + (nbytes, flops)


def commit_scan_bound(tab, need) -> tuple:
    """Least time for one K5 launch: the state, the tables and each step's
    rows read once, each step's pool read (s_m, s_u, s_rank) through the
    W-th eligible unit of its longest prefix walk as the plain version
    counted it, and the counts written once; or its float64 operations
    per step (prefix sums, unit-price sums, the chosen units' sums)."""
    import numpy as np
    B, M = tab["rank"].shape
    R = tab["u_tab"].shape[1]
    N = tab["n_nodes"]
    W = tab["W"]
    nbytes = (2 * (tab["free"].nbytes + tab["gamma"].nbytes)
              + tab["P_tab"].nbytes + tab["node_row"].nbytes
              + B * (8 + 4 + 1 + M * 4 + R * 8)
              + int(np.sum(need)) * 12 + int(W.sum()) * R * 12
              + B * (1 + 4 + M * 4 + 4 + 8 + R * 4))
    flops = B * (N * R * 6 + int(W.max(initial=0)) * (M + R))
    return _time_bound(nbytes, flops) + (nbytes, flops)


def sched_case(n: int, topo: str):
    """K4 and K5 on one fig5 round's tables: check (raises on any
    difference beyond one ulp of a spread payoff), then time each kernel
    on the card (``ms``), each call of its wrapper as the decision path
    makes it (``wrapper_ms``: checks, allocation, a read of max W, launch)
    and its plain version.  Returns two rows."""
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
        log(f"[kernel] {name} n={n} {topo:6s} B={B} M={M} N={row['N']} "
            f"L={row['L']} bitwise={not verdict['mismatched']} "
            f"pay_ulps={verdict['pay_ulps']} kernel_ms={ms:.4f} "
            f"wrapper_ms={wrapper_ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound[0]:.5f} ({bound[1]})")
        rows.append(row)
    return rows


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


def phase_simulate():
    """``simulate`` of the fig5 trace of SIM_JOBS jobs on its grown
    cluster with ``solver="cuda"`` and ``"numpy"``: average JCT, makespan
    and every job's finish time must be equal; the cuda run must launch
    K4 and K5, the numpy run no kernel."""
    from repro_torch.core.hadar import HadarScheduler
    from repro_torch.core.simulator import simulate
    from repro_torch.core.types import clone_jobs
    jobs, cluster, _ = fig5_round(SIM_JOBS, "grown")
    res = {}
    for solver in ("cuda", "numpy"):
        zero_launches()
        t0 = time.perf_counter()
        r = simulate(HadarScheduler(solver=solver), clone_jobs(jobs), cluster)
        wall = time.perf_counter() - t0
        res[solver] = {
            "avg_jct_s": r.avg_jct(), "makespan_s": r.total_seconds,
            "finish": [j.finish_time for j in sorted(r.jobs,
                                                     key=lambda j: j.job_id)],
            "rounds": len(r.rounds),
            "consultations": sum(1 for x in r.rounds if x.sched_seconds > 0),
            "sched_s": sum(x.sched_seconds for x in r.rounds),
            "wall_s": wall, "launches": read_launches()}
    same = all(res["cuda"][k] == res["numpy"][k]
               for k in ("avg_jct_s", "makespan_s", "finish", "rounds"))
    out = {"jobs": SIM_JOBS, "equal": same,
           **{f"{b}_{k}": v for b in res for k, v in res[b].items()
              if k != "finish"}}
    log("[simulate] " + json.dumps(out))
    if not same:
        raise RuntimeError("simulate: the cuda and numpy solvers give "
                           "different results")
    if any(res["numpy"]["launches"].values()) or not (
            res["cuda"]["launches"]["find_alloc"]
            and res["cuda"]["launches"]["commit_scan"]):
        raise RuntimeError(f"simulate: launches cuda "
                           f"{res['cuda']['launches']}, numpy "
                           f"{res['numpy']['launches']}")
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
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "kernel_cases": rows,
                                   "prefill": prefill, "serve": serve,
                                   "prefill_rwkv": prefill_rwkv,
                                   "serve_rwkv": serve_rwkv,
                                   "schedule": schedule, "simulate": sim,
                                   "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

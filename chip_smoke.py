#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (an H100 is the target).

    python3 chip_smoke.py [--seed N] [--out FILE.json]

Builds every hand-written kernel from ``src/repro_torch/kernels/csrc`` and
drives the port's paths with random weights and traces from ``--seed``:
llama3.2-1b and rwkv6-7b at full width and depth (flash attention K1, the
WKV6 scan K2, RMSNorm K3), qwen3-moe-235b-a22b, grok-1-314b and
qwen2.5-32b at full width and cut depth (K1, K3), hymba-1.5b, internvl2-2b
and whisper-tiny at full width and depth (K1, and K3 but for whisper's
LayerNorms), and the Hadar decision path on the fig5 shape
(FIND_ALLOC K4, the greedy commit K5), through the round and the event
engine, HadarE's forked copies and the scheduling env, with and without
faults, the policy-comparison table under the runtime sanitizer, and two
faulted runs under the observer; and training through the kernels, with
the backward kernels K1b, K2b and K3b.  Any failure raises and the script
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
   prefill shapes, the prefill shapes of qwen3-moe (64 q heads over 4 kv
   heads, D=64), grok-1 (48/8, D=128), granite-34b (48/1, MQA) and
   qwen2.5-32b (40/8) at 4 x 1024 tokens in the model layout, hymba-1.5b
   (25/5, D=64, window 2048) at 4 x 1024, internvl2-2b (16/8, D=128) at
   4 x 1280 (256 patches + 1024 tokens) and whisper-tiny's decoder (6/6,
   D=64, no window) at 4 x 448, ragged S=100 and S=1000, a window of 300
   at S=2048 (its lower edge inside a key tile), D=128 at S=1024 (a row in
   two swizzle boxes) and hymba's shape at S=4096, where its 2048 window
   bites; every case runs twice and the two outputs must be
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
1b. backward -- each backward kernel against autograd of its kernel's
   plain version on the card (``_plain_grads``), run twice, the two
   results bitwise equal; float32 gradients within ``BWD_F32_REL_TOL`` of
   the largest value, bf16 by ``rowblock_rel_err`` within 3e-2 (K3b's dx
   within one bf16 ulp of each row's largest value).  K1b: the K1 sweep
   in both dtypes and masks, the llama3.2-1b train shape in the model
   layout, every config's attention (``MODEL_ATTENTION``), ragged
   non-causal S=100, windows biting at S=2048 and 4096, D=128, float32
   ragged S=1000; each row names its form (``flash_attention_bwd.FORMS``:
   "wgmma" for bf16, "f32" for float32) and pass 1's head split, after the
   build's ptxas lines (registers, spills); timed beside SDPA's backward
   (a yardstick only).  K2b:
   the K2 sweep, the rwkv6-7b train shape (its plain version on the first
   ``K2B_PLAIN_STEPS`` steps, and at the full length on
   ``K2B_LAYER_SLICE`` with du against its closed form), ragged S=1000,
   D=16 and 128, S=17, decays of exactly 0; each row names its form and
   cluster size (``rwkv6_scan_bwd.plan``).  K3b: the llama and rwkv6
   norms in bf16 and float32, ragged, strided x and dy, a ragged row
   count, an f32 scale with bf16 x, rows where eps matters; each row
   names its form ("regs" or "general") and rows a block
   (``rmsnorm_bwd.plan_of``); timed beside ``F.rms_norm``'s backward.
   The ptxas lines of all three builds come first.  No PyTorch call computes WKV6's backward.
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
8. events -- ``simulate_events`` of the 128-job fig5 trace (``EVENT_JOBS``)
   under the same model
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
11. env -- (a) ``repro_torch.env.run_policy`` of
   ``HadarScheduler(solver="cuda")`` through ``ClusterSchedulingEnv`` on
   phase 8's 128-job trace, cluster and failure model (reward neg_jct,
   price observations on), traced as in 8: the result equal to phase 8's
   cuda ``simulate_events`` result in every field but host time, K4 and
   K5 launched, every step's observation consistent (queue plus running
   rows the active jobs, ``0 <= free <= capacity``, the price finite and
   positive on up nodes and ``+inf`` on down ones), the rewards summing
   to -sum(JCT)/3600 within 1e-9 relative where every job finishes.
   Reports the wall, seconds a step and the host time spent building
   observations.  (b) ``repro_torch.env.compare`` of every default
   policy on ``philly_trace(COMPARE_JOBS, seed=1)`` and
   ``simulation_cluster()`` under ``FAULT_MODEL``, event mode,
   ``solver="cuda"``, with ``REPRO_SANITIZE=1`` (PriceState,
   ``dp_allocation``, K4's candidates and K5's carry checked as well as
   the engines): a valid table, no invariant violated, each row that of
   the JAX package (``REF_COMPARE``; floats within 1e-9 relative),
   Hadar's TTD below every blind policy's, K4 and K5 launched by the
   Hadar and HadarE runs and nothing by the others; then the Hadar and
   HadarE rows once more without the sanitizer, equal.  Each policy's
   wall is reported.
12. obs -- phase 7's faulted round run and phase 10's HadarE run again,
   each under ``repro_torch.obs.session`` writing its trace, decision log
   and metrics, with ``solver="cuda"`` and then ``"numpy"``
   (``run_observed``), held by ``check_observed``: the cuda result equal
   to the unobserved one that phase handed on in every field but host
   time, K4's and K5's launches equal to its; the saved trace valid, its
   sim-track ``interval`` spans the round records bitwise in ``ts`` and
   ``dur``; each logged unit price Eq. 5 of its logged gamma, cap, u_min
   and u_max bitwise; no runner-up above its winner; the decision log
   the numpy run's record by record (but for ``solver``; the runner-ups'
   kind, node, prefix and servers equal, payoffs within one ulp, and how
   many differ is reported); the counts of decisions, evictions,
   consults, faults, completions, PriceState operations and HadarE's
   consolidation instants those of the JAX package (``REF_OBS``).  So
   K5's runner-up outputs (``win2``, ``win2_pay``, ``sp_nserv``) are read
   on the card.  Reports each run's observed and unobserved wall and the
   trace's totals of the consult's spans (``OBS_SPANS``).

13. prefill_moe -- phase 2 for qwen3-moe-235b-a22b at full width (d_model
   4096, 64 q heads over 4 kv heads of 64, 128 experts of d_ff 1536,
   top-8, the grouped form), 8 of its 94 layers in bf16 (41.7 GB): K1 8
   times and K3 17 times per kernel-path forward; the float32 draws at
   depths 1 and 2.  Each layer's routing (top-k experts and kept slots)
   is computed on both paths' own MoE input: the tokens routed
   differently are reported, at most 0.1% of them in float32, and the
   layer outputs are held to 2e-4 on the tokens routed alike.  On the
   first float32 layer, the JAX package's property of its MoE forms:
   ``moe_ffn_grouped``, ``_flat`` and ``_dense`` within 2e-4 of the
   largest output at capacity factor 8, the grouped form twice bitwise
   equal, and finite at factor 0.05.  Runs after phase 5, as do 14-22.
14. serve_moe -- phase 3 for qwen3-moe at 8 layers; decode takes the
   grouped form at S = 1 and launches no kernel.
15. prefill_grok -- phase 13 for grok-1-314b at full width (d_model 6144,
   48/8 heads of 128, 8 experts of d_ff 32768, top-2, the dense form), 4
   of its 64 layers (42.6 GB): K1 4 times and K3 9 times; float32 at
   depth 1.
16. prefill_qwen2 -- phase 2 for qwen2.5-32b at full width (d_model 5120,
   40/8 heads of 128, QKV bias drawn non-zero from the seed), 16 of its 64
   layers: K1 16 times and K3 33 times; float32 at depths 1 and 2.
17. prefill_hymba -- phase 2 for hymba-1.5b at full width and depth (32
   layers, d_model 1600, 25/5 heads of 64, window 2048, a mamba mix of
   inner width 3200 and state 16 beside the attention; the scan is plain
   PyTorch, a log-step scan of 10 whole-tensor steps at S = 1024): K1 32
   times and K3 129 times (4 a layer: ln1, the two branches' ln_pa and
   ln_pm, ln2; + the final norm); float32 at depths 1 and 2; and the
   float32 model at 2 layers decoded token by token from a zero cache
   against ``forward`` through both paths on 64 tokens, within 2e-3 (the
   one place where mamba's conv and SSM state carry runs on the card).
18. serve_hymba -- phase 3 for hymba at full depth; no kernel launches.
19. prefill_internvl2 -- phase 2 for internvl2-2b at full width and depth
   (24 layers, d_model 2048, 16/8 heads of 128, untied 92,553-wide
   unembed), 256 seeded patch embeddings ahead of each 1024-token text:
   K1 24 times at S = 1280 and K3 49 times; float32 at depths 1 and 2.
20. serve_internvl2 -- phase 3 for internvl2; the served model sees text.
21. prefill_whisper -- phase 2 for whisper-tiny at full width and depth
   (4 + 4 layers, d_model 384, 6/6 heads of 64) on 1500 seeded frames
   and 448 decoder tokens: K1 4 times (the decoder's causal self
   attention; the bidirectional encoder and the cross attention take the
   plain path, as in the JAX package), K3 none (LayerNorms); each decoder
   layer checked on the cross K/V of the encoder's output; float32 at
   depths 1, 2 and 4.
22. serve_whisper -- phase 3 for whisper; the decoder cross-attends the
   zero cross K/V, as the JAX package's engine does.
23. train -- llama3.2-1b at full width and depth (16 layers, bf16,
   ``remat``), ``TRAIN_STEPS`` AdamW steps (``TRAIN_OC``) on one batch of
   4 x 1024 tokens from ``repro_torch.data.pipeline``: each step's
   launches exact (``train_launches``: K1 32, K1b 16, K3 65, K3b 33), its
   loss and grad norm finite, the last loss below the first; during step
   2 every K1b and K3b call checked on its own inputs as in 1b; the step
   timed (median of the last five) beside the plain path's, split into
   forward, backward and optimizer by CUDA events, and the peak memory;
   the float32 model at depth 2: every parameter's gradient through the
   kernel path against a float64 gradient (``TRAIN_F32_GRAD_TOL``, or
   ``F64_FACTOR`` times the plain path's own error).
24. train_rwkv -- the same for rwkv6-7b at 8 of 32 layers (K2 16, K2b 8,
   K3 33, K3b 17 a step), its plain path timed on one step, its float32
   gate at 256 tokens.
25. train_families -- one kernel-path step of each of the ten configs at
   ``reduced(max_d_model=128)``: a finite loss, the parameters moved and
   finite, the launches exact.
26. train_scheduled -- ``repro_torch.launch.train.run_scheduled_training``
   on the card through the kernels for hadare, hadar and gavel:
   HadarE's CRU 1.0, every eval loss finite and below its job's initial
   one, HadarE's rounds at or below Hadar's (``tests/test_system.py``).
27. mesh -- last, so that its process group cannot disturb the others:
   (a) HadarE's ``pod_consolidate`` of two full-width llama3.2-1b bf16
   copies (seeds 0 and 1, steps 3 and 5) on DTensors over a one-rank
   NCCL ``(1, 1, 1)`` ("pod", "data", "model") mesh (a ``FileStore`` in a
   temporary directory), bitwise equal to the plain call,
   both timed by CUDA events; (b) ``repro_torch.launch.dryrun``
   in subprocesses: llama3.2-1b ``train_4k`` on the fake 16x16 mesh and
   its consolidation on 2x16x16, each record ``ok``, its argument bytes
   those of the port's placements, its FLOPs a device's (above 0, below
   the unsharded trace's), the consolidation's collectives all-reduces of
   2 x 4 x the local elements.  No kernel runs in it.

Full-depth agreement of the two model paths is printed, not gated: the
random init makes a deep stack chaotic.  It prints a ``{"kernels":
[...]}`` line, the card's name and power limit, and last ``{"ok": true,
"device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import json
import math
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
# float32 K1 in a model layer at D = 128 (``_attention_check``): the
# kernel's max abs error against the float64 attention, over the plain
# version's own
F64_FACTOR = 2.0
ROW_BLOCK = 64
SWEEP = [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
         (2, 2, 2, 384, 32)]
MASKS = [(True, 0), (True, 96), (False, 0)]
# llama3.2-1b: 32 q heads, 8 kv heads, head dim 64, window 8192
LLAMA_PREFILL = (4, 32, 8, 1024, 64, "bfloat16", True, 8192)
# the attention of the other configs' prefills at batch 4 (Hq, Hkv, head
# dim, sequence, window): qwen3-moe G = 16, grok-1 G = 6, granite-34b MQA
# (G = 48), qwen2.5-32b G = 5 on 1024 tokens; hymba-1.5b G = 5 on 1024
# tokens with its 2048 window; internvl2-2b G = 2 on 256 patches + 1024
# tokens; whisper-tiny's decoder (6/6) on its 448-token context, no window
MODEL_ATTENTION = {"qwen3-moe-235b-a22b": (64, 4, 64, 1024, 8192),
                   "grok-1-314b": (48, 8, 128, 1024, 8192),
                   "granite-34b": (48, 1, 128, 1024, 8192),
                   "qwen2.5-32b": (40, 8, 128, 1024, 8192),
                   "hymba-1.5b": (25, 5, 64, 1024, 2048),
                   "internvl2-2b": (16, 8, 128, 1280, 8192),
                   "whisper-tiny": (6, 6, 64, 448, 0)}
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
# the trace of the faulted event run (phase events) and of the env episode
# that repeats it (phase env), cut from SIM_JOBS to keep the smoke's time:
# grown_cluster(128) is 16 nodes, the run 864 events and 735 consults
EVENT_JOBS = 128
# the faulted round run's trace, cut from SIM_JOBS to keep the smoke's
# time: grown_cluster(48) is 15 nodes, the run takes 322 rounds, 18 of
# its consults queue more than 24 jobs (the greedy path, K5)
FAULT_ROUND_JOBS = 48
# the failure model of the faulted runs (phases 7, 8 and 10): on
# grown_cluster(128), 16 nodes, it draws 47 windows over its week, 7 of
# them spot reclaims; on grown_cluster(48), 46 windows, 7 spot
FAULT_MODEL = dict(seed=7, mtbf_hours=72.0, spot_frac=0.2,
                   spot_reclaim_hours=24.0)
# The JAX package's results for the same runs, each with its own
# HadarScheduler(solver="numpy") and FAULT_MODEL on the fig5 grown
# cluster (benchmarks/fig5_scalability.grown_cluster), run once on a CPU:
# repro.sim.engine.simulate_events of philly_trace(EVENT_JOBS, seed=1), and
# simulate_rounds of philly_trace(FAULT_ROUND_JOBS, seed=1).
REF_EVENTS = {"n_events": 864, "sched_calls": 735, "evictions": 33,
              "avg_jct_s": 111159.69755803476,
              "makespan_s": 217736.4780284858}
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
# phase 11: the policy-comparison table of COMPARE_JOBS fig5 jobs on
# simulation_cluster() under FAULT_MODEL, event mode, with the sanitizer
# on.  The JAX package's table for the same call with solver="numpy"
# (repro.env.compare.compare of philly_trace(COMPARE_JOBS, seed=1) and
# DEFAULT_POLICIES), run once on a CPU: its rows, in policy order.
COMPARE_JOBS = 48
REF_COMPARE = [
    {"policy": "hadar", "mode": "event", "ttd_hours": 31.33439450046641,
     "avg_jct_s": 44535.02724507419, "gru": 0.8325218729451063,
     "cru": 0.8690995337666532, "gru_overall": 0.8328709377450852,
     "goodput": 0.8312107169225766, "evictions": 10, "restarts": 329,
     "completed": 48, "n_jobs": 48},
    {"policy": "gavel", "mode": "event", "ttd_hours": 32.890713028282725,
     "avg_jct_s": 53178.03463270378, "gru": 0.780267005996265,
     "cru": 0.7936351967090487, "gru_overall": 0.7812086217888186,
     "goodput": 0.7798438746151495, "evictions": 4, "restarts": 1671,
     "completed": 48, "n_jobs": 48},
    {"policy": "hadare", "mode": "round", "ttd_hours": 17.0,
     "avg_jct_s": 30933.125285635764, "gru": 0.9297806005118097,
     "cru": 1.0, "gru_overall": 0.9298554003333223,
     "goodput": 0.9298444813955165, "evictions": 3, "restarts": 52,
     "completed": 37, "n_jobs": 48},
    {"policy": "fcfs", "mode": "event", "ttd_hours": 95.06879326248823,
     "avg_jct_s": 75175.64184867572, "gru": 0.46185312321375493,
     "cru": 0.4891122222571118, "gru_overall": 0.46190278081713176,
     "goodput": 0.4609615571139368, "evictions": 14, "restarts": 0,
     "completed": 48, "n_jobs": 48},
    {"policy": "sjf", "mode": "event", "ttd_hours": 58.09766448258085,
     "avg_jct_s": 53120.98315797744, "gru": 0.7564870038400082,
     "cru": 0.8110692374385439, "gru_overall": 0.7565330617846608,
     "goodput": 0.7531494973470214, "evictions": 17, "restarts": 0,
     "completed": 48, "n_jobs": 48},
    {"policy": "sjf_pred", "mode": "event", "ttd_hours": 50.12249956074752,
     "avg_jct_s": 50303.03537863101, "gru": 0.6872082152214983,
     "cru": 0.7343906816316662, "gru_overall": 0.6872470156380419,
     "goodput": 0.6845467101299406, "evictions": 11, "restarts": 0,
     "completed": 48, "n_jobs": 48},
    {"policy": "srtf", "mode": "event", "ttd_hours": 96.82898263097597,
     "avg_jct_s": 55970.02503911071, "gru": 0.39656838210154605,
     "cru": 0.45546085118552704, "gru_overall": 0.3967033262704648,
     "goodput": 0.3954462257677552, "evictions": 11, "restarts": 8,
     "completed": 48, "n_jobs": 48},
    {"policy": "maxmin", "mode": "event", "ttd_hours": 55.21132119032024,
     "avg_jct_s": 55591.31864396855, "gru": 0.5411118486115459,
     "cru": 0.5679466348031799, "gru_overall": 0.5414190429595224,
     "goodput": 0.5407692948364975, "evictions": 9, "restarts": 527,
     "completed": 48, "n_jobs": 48},
    {"policy": "tiresias", "mode": "event", "ttd_hours": 31.16832958416871,
     "avg_jct_s": 50311.13989478158, "gru": 0.8656209814326282,
     "cru": 0.8969116561913621, "gru_overall": 0.8657809729955278,
     "goodput": 0.8649374318225936, "evictions": 5, "restarts": 1058,
     "completed": 48, "n_jobs": 48},
    {"policy": "yarn-cs", "mode": "event", "ttd_hours": 50.56990740740741,
     "avg_jct_s": 43375.037383050694, "gru": 0.6054670427784544,
     "cru": 0.6172713642888117, "gru_overall": 0.6056058543805413,
     "goodput": 0.6049134171224063, "evictions": 4, "restarts": 0,
     "completed": 48, "n_jobs": 48}]
# the policies whose runs in that table reach the kernels: Hadar's and
# HadarE's consults launch K4, and each takes the greedy commit on a
# queue longer than max_exact_dp (24) where a wave stalls (K5)
COMPARE_KERNEL_POLICIES = ("hadar", "hadare")
# phase 12: phase 7's faulted round run ("rounds") and phase 10's HadarE
# run ("hadare") again under repro_torch.obs.  The JAX package's counts
# for the same runs under repro.obs.session, each with its own
# HadarScheduler(solver="numpy") and FAULT_MODEL, run once on a CPU: the
# counters, and the hadare.consolidation instants of the trace.
REF_OBS = {
    "rounds": {"consults": 252, "decisions": 509, "faults.evictions": 10,
               "faults.node_fail": 6, "faults.node_recover": 6,
               "faults.spot_preempt": 1, "jobs_completed": 48,
               "pricestate_commit_batchs": 212, "pricestate_commits": 509,
               "pricestate_refreshes": 239, "hadare.consolidation": 0},
    "hadare": {"consults": 170, "decisions": 867, "faults.evictions": 3,
               "faults.node_fail": 2, "faults.node_recover": 2,
               "jobs_completed": 37, "pricestate_commit_batchs": 142,
               "pricestate_commits": 867, "pricestate_refreshes": 165,
               "hadare.consolidation": 170}}
# the round of both runs: the engines' default, which phases 7 and 10 use
OBS_ROUND = 360.0
# the consult's host work as the trace splits it (wall-clock spans)
OBS_SPANS = ("consult", "hadar.dp", "solver_dispatch", "pricestate.refresh")
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
    cases += [LLAMA_PREFILL + (True, 20)]
    cases += [(4, Hq, Hkv, S, D, "bfloat16", True, w, True, 20)
              for Hq, Hkv, D, S, w in MODEL_ATTENTION.values()]
    cases += [(4, 32, 8, 2048, 64, "bfloat16", True, 8192, False, 20),
              (1, 32, 8, 1000, 64, "bfloat16", True, 8192, False, 20),
              (1, 32, 8, 1000, 64, "bfloat16", False, 0, False, 10),
              (1, 32, 8, 1000, 64, "float32", False, 0, False, 10),
              (2, 4, 2, 100, 32, "bfloat16", False, 0, False, 10),
              (1, 32, 8, 2048, 64, "bfloat16", True, 300, False, 10),
              (2, 16, 4, 1024, 128, "bfloat16", True, 0, False, 10),
              (1, 25, 5, 4096, 64, "bfloat16", True, 2048, False, 10)]
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
# phase backward: K1b, K2b, K3b against autograd of their plain versions
# ---------------------------------------------------------------------------

# A float32 gradient of a backward kernel: max abs error over the largest
# |plain gradient| (both sum in float32, in other orders).  A bfloat16
# gradient: ``rowblock_rel_err`` for (B,H,S,D) outputs, else the max abs
# error over the largest value, within BF16_REL_TOL; dx of K3b within one
# bf16 ulp of each row's largest value, as K3's forward.
BWD_F32_REL_TOL = 1e-4


def grad_gate(got, want) -> dict:
    """One gradient of a backward kernel against its plain version's,
    gated by its dtype."""
    import torch
    abs_err = float((got.float() - want.float()).abs().max())
    rel = abs_err / max(float(want.float().abs().max()), 1e-30)
    if got.dtype == torch.float32:
        return {"max_abs_err": abs_err, "max_rel_err": rel,
                "gated_on": "max_rel_err", "tol": BWD_F32_REL_TOL,
                "ok": rel < BWD_F32_REL_TOL}
    blk = rowblock_rel_err(got, want) if got.dim() == 4 else rel
    return {"max_abs_err": abs_err, "max_rel_err": blk,
            "gated_on": "max_rel_err", "tol": BF16_REL_TOL,
            "ok": blk < BF16_REL_TOL}


def _grads_gate(names, got, want) -> dict:
    """``grad_gate`` of each named gradient; "ok" and the worst
    "max_abs_err" over them."""
    errs = {n: grad_gate(g, w) for n, g, w in zip(names, got, want)}
    return {**errs, "ok": all(e["ok"] for e in errs.values()),
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "max_rel_err": max(e["max_rel_err"] for e in errs.values())}


def _plain_grads(fn, inputs, grad_out, retain=False):
    """Autograd of ``fn`` (a plain version in ``kernels/ref.py``) on
    detached copies of ``inputs``: (grads, a closure that runs the same
    backward again on the kept graph, for timing)."""
    import torch
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves)
        if isinstance(out, tuple):
            out = out[0]
        grads = torch.autograd.grad(out, leaves, grad_out,
                                    retain_graph=retain)
    again = (lambda: torch.autograd.grad(out, leaves, grad_out,
                                         retain_graph=True)) if retain \
        else None
    return grads, again


def ptxas_lines(name: str) -> list:
    """The register, shared-memory and spill lines of ``name``'s build,
    each after the (mangled) name of its kernel, from the build log (none
    if an earlier process built it)."""
    from repro_torch.kernels import build
    out, entry = [], None
    for line in build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def k1b_bound(B, Hq, Hkv, S, D, causal, window, dtype):
    """Least time for K1b's function: its five products over the pairs
    the mask leaves (scale q k^T, dO v^T, dV, dQ, dK) at the type's peak,
    or q, k, v, dO read once and dq, dk, dv written once (the gradient
    needs no o: delta = sum_j P dP).  Returns (ms, "bytes" |
    "operations", flops, bytes)."""
    _, _, fwd_flops, _ = attention_bound(B, Hq, Hkv, S, D, causal, window,
                                         dtype)
    flops = fwd_flops // 2 * 5     # attention_bound counts two products
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (3 * B * Hq * S * D + 4 * B * Hkv * S * D)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def k1b_cases():
    """(B, Hq, Hkv, S, D, dtype, causal, window, model_layout, iters) of
    every K1b case: the K1 sweep (``SWEEP`` x dtypes x ``MASKS``), the
    llama3.2-1b train shape in the model layout (the main-path row) and
    every config's attention (``MODEL_ATTENTION``), then ragged
    non-causal S=100 at D=32 in both dtypes, a 300 window biting at
    S=2048, D=128 at S=1024, hymba's 2048 window biting at S=4096 and
    float32 causal ragged S=1000."""
    cases = [(B, Hq, Hkv, S, D, dt, c, w, False, 5)
             for (B, Hq, Hkv, S, D) in SWEEP
             for dt in ("float32", "bfloat16") for c, w in MASKS]
    cases += [LLAMA_PREFILL + (True, 5)]
    cases += [(4, Hq, Hkv, S, D, "bfloat16", True, w, True, 3)
              for Hq, Hkv, D, S, w in MODEL_ATTENTION.values()]
    cases += [(2, 4, 2, 100, 32, "bfloat16", False, 0, False, 5),
              (2, 4, 2, 100, 32, "float32", False, 0, False, 5),
              (1, 32, 8, 2048, 64, "bfloat16", True, 300, False, 3),
              (2, 16, 4, 1024, 128, "bfloat16", True, 0, False, 3),
              (1, 25, 5, 4096, 64, "bfloat16", True, 2048, False, 2),
              (1, 32, 8, 1000, 64, "float32", True, 8192, False, 3)]
    return cases


def k1b_inputs(case, gen):
    """q, k, v and a seeded dO of one K1b case, in the kernel layout
    (transposed (B,S,H,D) tensors for model-layout cases)."""
    import torch
    B, Hq, Hkv, S, D, dtype, causal, window, model_layout, _ = case
    dt = getattr(torch, dtype)

    def make(H):
        if model_layout:
            t = torch.randn((B, S, H, D), generator=gen, device="cuda")
            return t.to(dt).transpose(1, 2)
        return torch.randn((B, H, S, D), generator=gen, device="cuda").to(dt)

    return make(Hq), make(Hkv), make(Hkv), make(Hq)


def k1b_check(q, k, v, do, causal, window, bwd=None):
    """K1b (``bwd``, default the binding's) twice and autograd of
    ``ref.flash_attention_ref`` on the same kernel-layout inputs: the
    gates of dq, dk, dv and "deterministic"."""
    import torch
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref
    bwd = bwd or fab.flash_attention_bwd
    got = bwd(q, k, v, do, causal, window)
    again = bwd(q, k, v, do, causal, window)
    want, _ = _plain_grads(lambda *t: ref.flash_attention_ref(
        *t, causal, window), (q, k, v), do)
    errs = _grads_gate(("dq", "dk", "dv"), got, want)
    errs["deterministic"] = all(torch.equal(a, b) for a, b in zip(got, again))
    errs["ok"] = errs["ok"] and errs["deterministic"]
    return errs


def k1b_case(case, gen):
    """One K1b case (``k1b_inputs``), checked (raises if over a limit or
    not bitwise deterministic), then K1b, the plain backward and SDPA's
    backward timed on the card (the two backwards on a kept graph,
    without their forwards)."""
    import torch
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ref
    B, Hq, Hkv, S, D, dtype, causal, window, model_layout, iters = case
    q, k, v, do = k1b_inputs(case, gen)
    errs = k1b_check(q, k, v, do, causal, window)
    if not errs["ok"]:
        raise RuntimeError(f"flash_attention_bwd at {case[:8]}: "
                           f"{json.dumps(errs)}")
    ms = device_ms(lambda: fab.flash_attention_bwd(q, k, v, do, causal,
                                                   window), iters)
    _, plain = _plain_grads(lambda *t: ref.flash_attention_ref(
        *t, causal, window), (q, k, v), do, retain=True)
    plain_ms = cuda_ms(plain, max(1, iters // 2), warmup=1)
    with torch.enable_grad():
        leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
        lib_out = sdpa_call(*leaves, causal, window)()
    library_ms = device_ms(lambda: torch.autograd.grad(
        lib_out, leaves, do, retain_graph=True), iters)
    del lib_out, plain
    bound_ms, bound_by, flops, nbytes = k1b_bound(B, Hq, Hkv, S, D, causal,
                                                  window, dtype)
    plan = fab.plan(B, Hq, Hkv, S, D, q.dtype)
    row = {"kernel": "flash_attention_bwd", "shape": [B, Hq, Hkv, S, D],
           "dtype": dtype, "causal": causal, "window": window,
           "model_layout": model_layout, "form": plan.form,
           "splits": plan.splits, **errs, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "bytes": nbytes}
    log(f"[backward] K1b B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} {dtype:8s} "
        f"form={plan.form} splits={plan.splits} "
        f"causal={int(causal)} window={window:5d} "
        f"dq/dk/dv err={errs['dq']['max_rel_err']:.3g}/"
        f"{errs['dk']['max_rel_err']:.3g}/{errs['dv']['max_rel_err']:.3g} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    return row


def k2b_bound(r, w, u):
    """Least time for K2b's function: 14 D^2 float32 operations per (b,
    h, t) (the forward state replayed, 3; the adjoint's update, 3; and
    four sums over the D x D state, dk, dw, dr and dv, 2 each) at the f32
    CUDA-core peak, or r, k, v, dO, w, u and S_0 read once and dr, dk, dv,
    dw and du written once.  Returns (ms, "bytes" | "operations", flops,
    bytes)."""
    B, H, S, D = r.shape
    n = B * H * S * D
    nbytes = (7 * n * r.element_size() + 2 * n * w.element_size()
              + 2 * u.numel() * u.element_size() + B * H * D * D * 4)
    flops = 14 * B * H * S * D * D
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


# K2b: (B, H, S, D, dtype, kind, iters): the K2 sweep in both dtypes; the
# rwkv6-7b train shape in the model layout (the main-path row; its plain
# version runs on the first K2B_PLAIN_STEPS steps, the kernel on those
# and, for determinism and time, on all 1024); ragged S=1000; D = 16 and
# 128 at ragged lengths; S=17 (one chunk and a ragged step); "zero", decays
# of exactly 0 over steps 40-44 and 0.01 over 32-95 (the model's
# exp(-exp(x)) reaches 0, so S_{t-1} cannot be recovered from S_t).
K2B_CASES = [(B, H, S, D, dt, "sweep", 5) for (B, H, S, D) in RWKV_SWEEP
             for dt in ("float32", "bfloat16")]
K2B_CASES += [RWKV_MAIN + ("bfloat16", "main", 5),
              (1, 64, 1000, 64, "bfloat16", "ragged", 3),
              (2, 4, 100, 16, "float32", "d16", 5),
              (1, 8, 200, 128, "bfloat16", "d128", 5),
              (2, 4, 17, 64, "bfloat16", "short", 5),
              (1, 8, 160, 64, "float32", "zero", 5)]
K2B_PLAIN_STEPS = 256
# K2b at the full length is checked on batch 0's first 8 heads (each (b, h)
# is its own scan) and du, a sum over the batch, over all
K2B_LAYER_SLICE = (slice(0, 1), slice(0, 8))


def k2b_check(r, k, v, w, u, s0, d_out, sl=None, bwd=None):
    """K2b twice and autograd of ``ref.rwkv6_scan_ref``'s output on the
    same kernel-layout inputs: the gates of dr, dk, dv, dw, du and
    "deterministic".  ``sl``: the (batch, head) slice the plain version
    runs on, the gradients but du compared on it (each (b, h) is its own
    scan); du, a sum over the batch and the sequence, against its closed
    form sum r k (dO . v), the plain gradient's own expression.  ``bwd``:
    the kernel's wrapper, default the binding's."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan_bwd as rkb
    bwd = bwd or rkb.rwkv6_scan_bwd
    got = bwd(r, k, v, w, u, s0, d_out)
    again = bwd(r, k, v, w, u, s0, d_out)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if sl is None:
        want, _ = _plain_grads(lambda *t: ref.rwkv6_scan_ref(*t, s0),
                               (r, k, v, w, u), d_out)
        errs = _grads_gate(("dr", "dk", "dv", "dw", "du"), got, want)
    else:
        b, h = sl
        want, _ = _plain_grads(lambda *t: ref.rwkv6_scan_ref(*t, s0[b, h]),
                               [t[b, h] for t in (r, k, v, w)] + [u[h]],
                               d_out[b, h])
        du = (r.float() * k.float() * (d_out.float() * v.float()).sum(
            -1, keepdim=True)).sum((0, 2)).to(u.dtype)
        errs = _grads_gate(("dr", "dk", "dv", "dw", "du"),
                           [t[b, h] for t in got[:4]] + [got[4]],
                           list(want[:4]) + [du])
    errs.update(deterministic=same, ok=errs["ok"] and same)
    return errs


def k2b_inputs(case, gen):
    """r, k, v, w, u, S_0 (``rwkv_inputs``: S_0 drawn non-zero) and a
    seeded d_out of one K2b case; "zero" sets decays of exactly 0."""
    import torch
    B, H, S, D, dtype, kind, _ = case
    r, k, v, w, u, s0 = rwkv_inputs(case, gen)
    if kind == "zero":
        w[:, :, 32:96] = 0.01
        w[:, :, 40:45] = 0.0
    if kind == "main":  # the model layout: (B,S,H,D) transposed
        d_out = torch.randn((B, S, H, D), generator=gen,
                            device="cuda").to(r.dtype).transpose(1, 2)
    else:
        d_out = torch.randn(r.shape, generator=gen,
                            device="cuda").to(r.dtype)
    return r, k, v, w, u, s0, d_out


def k2b_check_case(kind, args, bwd=None):
    """``k2b_check`` of one case's inputs; the "main" case's plain version
    on its first ``K2B_PLAIN_STEPS`` steps, and at the full length on
    ``K2B_LAYER_SLICE``.  Returns (errors, the plain version's inputs)."""
    r, k, v, w, u, s0, d_out = args
    if kind != "main":
        return k2b_check(*args, bwd=bwd), list(args)
    n = K2B_PLAIN_STEPS
    head = [t[:, :, :n] for t in (r, k, v, w)]
    errs = k2b_check(*head, u, s0, d_out[:, :, :n], bwd=bwd)
    full = k2b_check(*args, sl=K2B_LAYER_SLICE, bwd=bwd)
    errs.update(full_length=full, ok=errs["ok"] and full["ok"],
                deterministic=errs["deterministic"] and full["deterministic"],
                max_rel_err=max(errs["max_rel_err"], full["max_rel_err"]))
    return errs, head + [u, s0, d_out[:, :, :n]]


def k2b_case(case, gen):
    """One K2b case (``k2b_inputs``), checked (raises if over a limit or
    not bitwise deterministic), then K2b and the plain backward (on a kept
    graph) timed on the card."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan_bwd as rkb
    B, H, S, D, dtype, kind, iters = case
    args = k2b_inputs(case, gen)
    r, _, _, w, u, _, _ = args
    errs, plain_args = k2b_check_case(kind, args)
    plan = rkb.plan(B, H, S, D)
    cut = kind == "main"
    if not errs["ok"]:
        raise RuntimeError(f"rwkv6_scan_bwd at {case[:6]}: "
                           f"{json.dumps(errs)}")
    ms = device_ms(lambda: rkb.rwkv6_scan_bwd(*args), iters)
    *ins, s_0, dd = plain_args
    _, plain = _plain_grads(lambda *t: ref.rwkv6_scan_ref(*t, s_0), ins, dd,
                            retain=True)
    plain_ms = cuda_ms(plain, 1, warmup=0)
    del plain
    bound_ms, bound_by, flops, nbytes = k2b_bound(r, w, u)
    row = {"kernel": "rwkv6_scan_bwd", "shape": [B, H, S, D], "dtype": dtype,
           "kind": kind, "form": plan.form, "cluster": plan.cluster, **errs,
           "ms": ms, "plain_ms": plain_ms,
           "plain_steps": K2B_PLAIN_STEPS if cut else S, "library_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "bytes": nbytes}
    log(f"[backward] K2b B={B} H={H} S={S} D={D} {dtype:8s} {kind:6s} "
        f"form={plan.form} cluster={plan.cluster} "
        + " ".join(f"{g}={errs[g]['max_rel_err']:.3g}"
                   for g in ("dr", "dk", "dv", "dw", "du"))
        + f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"(S={row['plain_steps']}) bound_ms={bound_ms:.4f} ({bound_by})")
    return row


# K3b: (rows, D, dtype, scale dtype, kind, iters): the llama and rwkv6
# norms in bf16 and float32, a ragged 1000 x 1600 (bf16 with a float32
# scale, and float32), strided rows of x and of dy (each its own row
# stride), a row count past a multiple of the blocks', bf16 x with a
# float32 scale at 2048, and rows of magnitude 1e-3, where eps matters.
K3B_CASES = [(4096, 2048, "bfloat16", "bfloat16", "main", 20),
             (4096, 4096, "bfloat16", "bfloat16", "rwkv", 20),
             (4096, 2048, "float32", "float32", "main", 10),
             (4096, 4096, "float32", "float32", "rwkv", 10),
             (1000, 1600, "bfloat16", "float32", "ragged", 10),
             (1000, 1600, "float32", "float32", "ragged", 10),
             (4096, 2048, "bfloat16", "bfloat16", "strided", 10),
             (4097, 2048, "bfloat16", "bfloat16", "tail", 10),
             (4096, 2048, "bfloat16", "float32", "f32scale", 10),
             (1000, 2048, "float32", "float32", "small", 10)]


def k3b_inputs(case, gen):
    """x and scale (``rms_inputs``) and a seeded dy of one K3b case; for
    "strided" dy is the rows of a tensor of another width than x's."""
    import torch
    rows, D, dtype, sdtype, kind, iters = case
    x, scale = rms_inputs((rows, D, dtype, sdtype,
                           "main" if kind == "f32scale" else kind, iters),
                          gen)
    dy = torch.randn((rows, D + 512) if kind == "strided" else (rows, D),
                     generator=gen, device="cuda").to(x.dtype)
    if kind == "strided":
        dy = dy[:, 256:256 + D]
    return x, scale, dy


def k3b_check(x, scale, dy, eps=1e-5, bwd=None):
    """K3b (``bwd``, default the binding's) twice and autograd of
    ``ref.rmsnorm_ref``: dx row by row (float32 within BWD_F32_REL_TOL of
    the row's largest value, bf16 within one bf16 ulp of it), dscale by
    ``grad_gate``; "deterministic"."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm_bwd as rmb
    bwd = bwd or rmb.rmsnorm_bwd
    dx, ds = bwd(x, scale, dy, eps)
    dx2, ds2 = bwd(x, scale, dy, eps)
    (wx, ws), _ = _plain_grads(lambda *t: ref.rmsnorm_ref(*t, eps),
                               (x, scale), dy)
    tol = BWD_F32_REL_TOL if x.dtype == torch.float32 else RMS_BF16_ULP
    rel = row_rel_err(dx, wx)
    errs = {"dx": {"max_abs_err": float((dx.float() - wx.float()).abs().max()),
                   "max_rel_err": rel, "gated_on": "max_rel_err", "tol": tol,
                   "ok": rel <= tol and dx.dtype == x.dtype
                   and dx.shape == x.shape},
            "dscale": grad_gate(ds, ws)}
    if ds.dtype != torch.float32:   # one bf16 rounding of a float32 sum
        errs["dscale"].update(tol=RMS_BF16_ULP,
                              ok=errs["dscale"]["max_rel_err"] <= RMS_BF16_ULP)
    same = torch.equal(dx, dx2) and torch.equal(ds, ds2)
    return {**errs, "deterministic": same,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "max_rel_err": max(e["max_rel_err"] for e in errs.values()),
            "ok": errs["dx"]["ok"] and errs["dscale"]["ok"] and same}


def k3b_case(case, gen):
    """One K3b case: a seeded dy (strided like x for "strided"), checked
    (raises if over a limit or not bitwise deterministic), then K3b on x
    and dy read from device memory (``cold_copies``), the plain backward
    and ``F.rms_norm``'s backward (on kept graphs) timed on the card."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm_bwd as rmb
    rows, D, dtype, sdtype, kind, iters = case
    x, scale, dy = k3b_inputs(case, gen)
    errs = k3b_check(x, scale, dy)
    if not errs["ok"]:
        raise RuntimeError(f"rmsnorm_bwd at {case[:5]}: {json.dumps(errs)}")
    plan = rmb.plan_of(x, scale, dy)
    nbytes = 3 * rows * D * x.element_size() + 2 * D * scale.element_size()
    pairs = list(zip(cold_copies(x, nbytes), cold_copies(dy, nbytes)))
    ms = device_ms(cycled([lambda a=a, b=b: rmb.rmsnorm_bwd(a, scale, b)
                           for a, b in pairs]), iters)
    del pairs
    _, plain = _plain_grads(lambda *t: ref.rmsnorm_ref(*t, 1e-5),
                            (x, scale), dy, retain=True)
    plain_ms = cuda_ms(plain, iters)
    library_ms = None
    if hasattr(F, "rms_norm") and scale.dtype == x.dtype:
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(),
                      scale.detach().requires_grad_()]
            lib_out = F.rms_norm(leaves[0], (D,), leaves[1], 1e-5)
        library_ms = device_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dy, retain_graph=True), iters)
        del lib_out
    del plain
    flops = 10 * rows * D
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
    row = {"kernel": "rmsnorm_bwd", "shape": [rows, D], "dtype": dtype,
           "scale_dtype": sdtype, "kind": kind, "form": plan.form,
           "rows_per_block": plan.rows_per_block, **errs, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bytes": nbytes, "flops": flops}
    log(f"[backward] K3b {rows}x{D} {dtype:8s} scale {sdtype:8s} {kind:8s} "
        f"form={plan.form} rows/block={plan.rows_per_block} dx_err={errs['dx']['max_rel_err']:.3g} "
        f"dscale_err={errs['dscale']['max_rel_err']:.3g} kernel_ms={ms:.5f}"
        f" plain_ms={plain_ms:.4f} library_ms={library_ms} "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
    return row


def phase_backward(seed: int):
    """Every K1b, K2b and K3b case; returns (rows, {kernel: its main-path
    row})."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 11)
    t0 = time.perf_counter()
    for name, tag in (("flash_attention_bwd", "K1b"),
                      ("rwkv6_scan_bwd", "K2b"), ("rmsnorm_bwd", "K3b")):
        for line in ptxas_lines(name):
            log(f"[backward] {tag} ptxas {line}")
    rows = [k1b_case(c, gen) for c in k1b_cases()]
    rows += [k2b_case(c, gen) for c in K2B_CASES]
    rows += [k3b_case(c, gen) for c in K3B_CASES]
    log(f"[backward] {len(rows)} cases in {time.perf_counter() - t0:.1f} s")
    main = {"flash_attention_bwd": next(
                r for r in rows if r["kernel"] == "flash_attention_bwd"
                and r["model_layout"] and r["shape"] == [*LLAMA_PREFILL[:5]]),
            "rwkv6_scan_bwd": next(r for r in rows if r.get("kind") == "main"
                                   and r["kernel"] == "rwkv6_scan_bwd"),
            "rmsnorm_bwd": next(r for r in rows if r["kernel"] == "rmsnorm_bwd"
                                and r["kind"] == "main"
                                and r["dtype"] == "bfloat16")}
    return rows, main


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
    main = {"flash_attention": next(r for r in rows if r["model_layout"]
                                    and r["shape"] == [*LLAMA_PREFILL[:5]]),
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


def _depth_agreement(model, cfg, batch, depth: int) -> dict:
    """Kernel path vs einsum path, forward through the first ``depth``
    layers only (and the whole encoder): top-1 agreement and max |logit
    difference|."""
    from types import SimpleNamespace
    from repro_torch.models.model import forward
    part = SimpleNamespace(**dict(model.named_parameters(recurse=False)),
                           blocks=model.blocks[:depth],
                           enc=getattr(model, "enc", None))
    cfg = dataclasses.replace(cfg, n_layers=depth)
    lk, _ = forward(part, dataclasses.replace(cfg, attn_impl="pallas"),
                    batch)
    lx, _ = forward(part, dataclasses.replace(cfg, attn_impl="xla"), batch)
    return {"depth": depth, "top1": _top1(lk, lx),
            "max_abs_logit_diff": float((lk.float() - lx.float()).abs().max())}


def _routing(blk, h, cfg, grouped: bool = None):
    """The slots of the MoE layer ``blk`` on its input ``h``: each token's
    top-k experts in expert order (B,S,K) and whether the slot to each is
    kept (B,S,K) by the grouped form (``grouped``) or the dense form,
    which keeps every slot; by default the form ``moe.moe_ffn`` picks.
    Two of a token's top-k that swap places in the descending order give
    the same slots: the token's output is the same sum."""
    import torch
    from repro_torch.models import moe
    B, S, _ = h.shape
    _, topi, _ = moe.route((h @ blk.router).reshape(B * S, -1), cfg)
    topi = topi.reshape(B, S, -1)
    if grouped is None:
        grouped = cfg.n_experts >= moe.GROUPED_MIN_EXPERTS
    if grouped:
        keep, _ = moe._positions(topi.reshape(B, -1), cfg.n_experts,
                                 moe.capacity(S, cfg))
        keep = keep.reshape(topi.shape)
    else:
        keep = torch.ones_like(topi, dtype=torch.bool)
    experts, order = torch.sort(topi, dim=-1, stable=True)
    return experts, keep.gather(-1, order)


@contextlib.contextmanager
def _moe_inputs():
    """While active, records the input of every ``moe.moe_ffn`` call."""
    from repro_torch.models import moe
    inputs, ffn = [], moe.moe_ffn

    def recorded(p, h, cfg):
        inputs.append(h)
        return ffn(p, h, cfg)
    with mock.patch.object(moe, "moe_ffn", recorded):
        yield inputs


def _layerwise(model, cfg, batch, check) -> dict:
    """Every layer on the same input (the plain path's output of the layer
    before; the first takes ``forward``'s input, the vlm's patches ahead
    of the text, and every encdec layer the cross K/V of the encoder's
    output), so that nothing compounds across layers:

    - ``block_rel_diff``: the layer through both paths, max |difference|
      over max |output|;
    - ``kernel``: ``check(blk, x, positions, cfg)``, the kernel on the
      layer's own inputs against its plain version;
    - for the moe family, ``routed_differently``: the tokens whose experts
      or kept slots differ between the two paths (``_routing`` on each
      path's own MoE input), and ``experts_differ``: those whose experts
      differ.  A token across a top-k or capacity edge
      legitimately changes by O(1), so ``block_rel_diff`` is then taken
      over the other tokens only."""
    from repro_torch.models.attention import encoder_kv
    from repro_torch.models.blocks import block_fwd
    from repro_torch.models.model import encode, prefill_inputs
    win = cfg.sliding_window
    fk = block_fwd(dataclasses.replace(cfg, attn_impl="pallas"), win)
    fx = block_fwd(dataclasses.replace(cfg, attn_impl="xla"), win)
    x, positions, _ = prefill_inputs(model, cfg, batch)
    enc = (encode(model, cfg, batch["frames"]) if cfg.family == "encdec"
           else None)
    res = {"block_rel_diff": [], "kernel": []}
    if cfg.family == "moe":
        res.update(tokens=batch["tokens"].numel(), routed_differently=[],
                   experts_differ=[])
    for blk in model.blocks:
        extra = None if enc is None else encoder_kv(blk, enc)
        res["kernel"].append(check(blk, x, positions, cfg))
        with _moe_inputs() as inputs:
            yk, _ = fk(blk, x, positions, extra)
            yx, _ = fx(blk, x, positions, extra)
        diff = (yk.float() - yx.float()).abs().amax(-1)        # (B, S)
        size = yx.float().abs().amax(-1)
        if inputs:
            (tk, kk), (tx, kx) = (_routing(blk, h, cfg) for h in inputs)
            other = (tk != tx).any(-1)
            moved = other | (kk != kx).any(-1)
            res["experts_differ"].append(int(other.sum()))
            res["routed_differently"].append(int(moved.sum()))
            diff, size = diff[~moved], size[~moved]
        res["block_rel_diff"].append(float(diff.max() / size.max()))
        x = yx
        del yk, inputs
    return res


def _attention_f64(q, k, v, window: int):
    """Causal (sliding-window) GQA attention of kernel-layout q, k, v in
    float64: the exact function the f32 kernel and its plain version
    both round."""
    import torch
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    scores = torch.einsum("bhgqd,bhkd->bhgqk",
                          q.double().unflatten(1, (-1, G)), k.double())
    i = torch.arange(S, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window > 0:
        mask &= i[None, :] > i[:, None] - window
    probs = torch.softmax(scores.div_(math.sqrt(D)).masked_fill_(
        ~mask, -math.inf), dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", probs, v.double()).flatten(1, 2)


def _attention_check(blk, x, positions, cfg) -> dict:
    """K1 on a layer's own q, k, v (the model's score scale), called as
    ``forward`` calls it (``ops.flash_attention``, model layout in and
    out), against its plain version, by ``gate``.

    At the random init's magnitudes (outputs up to ~140) float32
    attention is exact only to ~1e-2 of the float64 result.  Where
    1/sqrt(D) is a power of two (D = 64) the kernel and the plain version
    round the scaled scores alike and agree within ``F32_TOL``; where it
    is not (D = 128) two float32 orders round apart by ~2e-2, so the
    float32 gate is then the kernel's error against the float64
    attention, within ``F64_FACTOR`` times the plain version's own
    (``plain_f64_abs_err``).  An encdec decoder layer attends after a
    LayerNorm and with no window, as its block does."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import apply_rope, layernorm, rmsnorm
    if cfg.family == "encdec":
        win, h = 0, layernorm(x, blk.ln1, blk.lnb1, cfg.norm_eps)
    else:
        win, h = cfg.sliding_window, rmsnorm(x, blk.ln1, cfg.norm_eps)
    q, k, v = attn.qkv(blk, h, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, window=win)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    out = out.transpose(1, 2)
    want = ref.flash_attention_ref(q, k, v, True, win)
    errs = gate(out, want, cfg.dtype)
    if cfg.dtype == "float32" and math.log2(q.shape[-1]) % 2:
        exact = _attention_f64(q, k, v, win)
        err = float((out.double() - exact).abs().max())
        plain = float((want.double() - exact).abs().max())
        errs.update(f64_abs_err=err, plain_f64_abs_err=plain,
                    gated_on="f64_abs_err", tol=F64_FACTOR * plain,
                    ok=err <= F64_FACTOR * plain)
    return errs


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
                                     flash_attention_bwd, rmsnorm,
                                     rmsnorm_bwd, rwkv6_scan, rwkv6_scan_bwd)
    return {"flash_attention": flash_attention, "rwkv6_scan": rwkv6_scan,
            "rmsnorm": rmsnorm, "find_alloc": find_alloc,
            "commit_scan": commit_scan,
            "flash_attention_bwd": flash_attention_bwd,
            "rwkv6_scan_bwd": rwkv6_scan_bwd, "rmsnorm_bwd": rmsnorm_bwd}


def zero_launches():
    for mod in _counters().values():
        mod.LAUNCHES = 0


def read_launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in _counters().items()}


def _check_launches(phase: str, got: dict, want: dict):
    if got != want:
        raise RuntimeError(f"{phase}: kernel launches {got}, want {want}")


def _forward_timed(model, cfg, batch, want: dict):
    """``FORWARD_REPS`` warmed-up ``forward`` calls, each timed on the
    host's clock, with every launch count set to 0 just before it and read
    just after (the main path's runs when ``cfg.attn_impl`` is "pallas");
    each run's counts must equal ``want``.  Returns (the last logits, the
    median wall time, the counts, every wall time): one call's wall time
    swings by a tenth or more with the host."""
    import torch
    from repro_torch.models.model import forward
    forward(model, cfg, batch)  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    walls = []
    for _ in range(FORWARD_REPS):
        zero_launches()  # the run starts here
        t0 = time.perf_counter()
        logits, _ = forward(model, cfg, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = read_launches()  # ... and ends here
        _check_launches(f"{cfg.name} forward ({cfg.attn_impl})", launches,
                        want)
    return logits, statistics.median(walls), launches, walls


# The parts of a forward that ``_forward_split`` times: (name, module,
# function); each is called through its module's attribute, so a patch of
# the attribute sees every call.  Parts nest: ssm_scan runs inside
# mamba_mix, and encode holds the encoder's self attention, which
# self_attention counts too.
SPLIT_PARTS = (
    ("encode", "repro_torch.models.model", "encode"),
    ("self_attention", "repro_torch.models.attention", "self_attention"),
    ("cross_attention", "repro_torch.models.attention", "cross_attention"),
    ("mamba_mix", "repro_torch.models.mamba", "mamba_mix"),
    ("ssm_scan", "repro_torch.models.mamba", "_ssm_scan"),
    ("time_mix", "repro_torch.models.rwkv", "time_mix"),
    ("channel_mix", "repro_torch.models.rwkv", "channel_mix"),
    ("moe_ffn", "repro_torch.models.moe", "moe_ffn"),
    ("swiglu", "repro_torch.models.blocks", "swiglu"),
    ("gelu_mlp", "repro_torch.models.blocks", "gelu_mlp"),
    ("unembed", "repro_torch.models.model", "_unembed"))


def _forward_split(model, cfg, batch) -> dict:
    """Where one ``forward`` spends the card's time: a CUDA event pair
    around each call of every ``SPLIT_PARTS`` part (the card's ms from the
    call's first operation to its last, idle gaps included), summed by
    part, and one pair around the whole forward (``forward_ms``).  Parts
    the family does not call are left out."""
    import importlib
    import torch
    from repro_torch.models.model import forward
    spans = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            spans.setdefault(name, []).append((e0, e1))
            return out
        return call

    with contextlib.ExitStack() as stack:
        for name, mod, attr in SPLIT_PARTS:
            mod = importlib.import_module(mod)
            stack.enter_context(mock.patch.object(
                mod, attr, timed(name, getattr(mod, attr))))
        torch.cuda.synchronize()
        f0 = torch.cuda.Event(enable_timing=True)
        f1 = torch.cuda.Event(enable_timing=True)
        f0.record()
        forward(model, cfg, batch)
        f1.record()
        torch.cuda.synchronize()
    res = {"forward_ms": f0.elapsed_time(f1)}
    for name, pairs in spans.items():
        res[f"{name}_ms"] = sum(a.elapsed_time(b) for a, b in pairs)
        res[f"{name}_calls"] = len(pairs)
    return res


def _check_logits(name, lg, shape):
    import torch
    if tuple(lg.shape) != shape or not bool(torch.isfinite(lg).all()):
        raise RuntimeError(f"{name} logits: shape {tuple(lg.shape)} or "
                           f"non-finite values")


# ---------------------------------------------------------------------------
# phases 2, 4, 13, 15 and 16: prefill
# ---------------------------------------------------------------------------

# The RMSNorms of a block (models/blocks.py ``block_fwd``): ln1 before the
# attention or the time mix and ln2 before the MLP or the channel mix; a
# hybrid block also normalises its attention and mamba branches (ln_pa,
# ln_pm).  ``forward`` adds the final norm.  encdec's norms are LayerNorms,
# which no kernel computes, so its kernel path launches no K3.
NORMS_PER_BLOCK = {"dense": 2, "vlm": 2, "moe": 2, "ssm": 2, "hybrid": 4,
                   "encdec": 0}


def norms_per_forward(cfg) -> int:
    per = NORMS_PER_BLOCK[cfg.family]
    return per * cfg.n_layers + 1 if per else 0


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
# ``forward``) and the per-layer check of it, the depth the bf16 model is
# cut to (None: full), the float32 model's depth (None: full), the depths
# at which its two paths are compared and the text's length (4 sequences
# of it; internvl2 puts its 256 patches ahead, whisper's encoder reads
# 1500 frames).  Every model runs at its published width.  Cuts:
# qwen3-moe 8 of 94 layers (4.90 GB of weights a layer, 2.49 GB of untied
# embeddings: 41.7 GB) and grok-1 4 of 64 (9.84 GB a layer, 3.22 GB of
# embeddings: 42.6 GB), so that the bf16 model and a forward's working set
# fit in the card's 80 GB, and the float32 draws (twice the bytes) at 2
# and 1 layers; qwen2.5-32b 16 of 64 (0.98 GB a layer) for the smoke's
# time.  hymba-1.5b, internvl2-2b and whisper-tiny run at full depth.
PREFILL = {
    "llama3.2-1b": {"kernel": "flash_attention", "check": _attention_check,
                    "layers": None, "f32_layers": None,
                    "depths": (1, 2, 4, 8, 16), "seq": 1024},
    "rwkv6-7b": {"kernel": "rwkv6_scan", "check": _scan_check,
                 "layers": None, "f32_layers": 2, "depths": (1, 2),
                 "seq": 1024},
    "qwen3-moe-235b-a22b": {"kernel": "flash_attention",
                            "check": _attention_check, "layers": 8,
                            "f32_layers": 2, "depths": (1, 2), "seq": 1024},
    "grok-1-314b": {"kernel": "flash_attention", "check": _attention_check,
                    "layers": 4, "f32_layers": 1, "depths": (1,),
                    "seq": 1024},
    "qwen2.5-32b": {"kernel": "flash_attention", "check": _attention_check,
                    "layers": 16, "f32_layers": 2, "depths": (1, 2),
                    "seq": 1024},
    "hymba-1.5b": {"kernel": "flash_attention", "check": _attention_check,
                   "layers": None, "f32_layers": 2, "depths": (1, 2),
                   "seq": 1024},
    "internvl2-2b": {"kernel": "flash_attention", "check": _attention_check,
                     "layers": None, "f32_layers": 2, "depths": (1, 2),
                     "seq": 1024},
    "whisper-tiny": {"kernel": "flash_attention", "check": _attention_check,
                     "layers": None, "f32_layers": None,
                     "depths": (1, 2, 4), "seq": 448},
}
# the tokens of the float32 decode-against-forward check of the hybrid
# family (``_decode_check``), where mamba's state carry runs on the card,
# and its limit (tests/test_decode_consistency.py)
DECODE_CHECK_SEQ = 64
DECODE_TOL = 2e-3
# the share of a float32 prefill's tokens that the kernel and the plain
# path may route differently at a layer (K1 and the plain attention differ
# by ~1e-7 relative, which moves a token across a top-k or capacity edge
# only where two of its router probabilities nearly tie)
MAX_ROUTED_DIFFERENTLY = 1e-3
# the JAX package's bound between its MoE forms (tests/test_moe_variants.py),
# here over the largest |output|; the capacity factors of that test
MOE_FORM_TOL = 2e-4
MOE_AUX_TOL = 1e-6
MOE_AMPLE, MOE_TIGHT = 8.0, 0.05


def _draw_biases(model, seed: int):
    """Every layer's ``bq``, ``bk`` and ``bv`` drawn N(0, 1) from
    ``seed``, layer by layer, so a cut model draws the same first layers:
    ``init_params`` starts them at zero, as the JAX package does, which
    would leave the bias path untested."""
    import torch
    gen = torch.Generator(device=model.embed.device)
    gen.manual_seed(seed)
    for blk in model.blocks:
        for name in ("bq", "bk", "bv"):
            b = getattr(blk, name)
            b.copy_(torch.randn(b.shape, generator=gen, device=b.device))


def _moe_forms(model, cfg, tokens) -> dict:
    """The JAX package's own property of its MoE forms
    (tests/test_moe_variants.py) at full width: on the first layer's MoE
    input, at ``MOE_AMPLE`` capacity, ``moe_ffn_grouped``, ``_flat`` and
    ``_dense`` agree within ``MOE_FORM_TOL`` of the largest |output| and
    their aux within ``MOE_AUX_TOL``; the grouped form run twice is bitwise
    equal; at ``MOE_TIGHT`` capacity it drops slots and its output is
    finite.  Raises otherwise."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.blocks import block_fwd
    blk = model.blocks[0]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    with _moe_inputs() as inputs:
        block_fwd(cfg, cfg.sliding_window)(blk, model.embed[tokens],
                                           positions)
    h = inputs[0]
    ample = dataclasses.replace(cfg, capacity_factor=MOE_AMPLE)
    outs, res = {}, {"capacity_factor": MOE_AMPLE}
    for form in ("moe_ffn_flat", "moe_ffn_grouped", "moe_ffn_dense"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[form] = getattr(moe, form)(blk, h, ample)
        torch.cuda.synchronize()
        res[f"{form}_s"] = time.perf_counter() - t0
    o0, a0 = outs["moe_ffn_flat"]
    size = float(o0.abs().max())
    for form in ("moe_ffn_grouped", "moe_ffn_dense"):
        o, a = outs[form]
        res[f"{form}_rel_diff"] = float((o - o0).abs().max()) / size
        res[f"{form}_aux_diff"] = abs(float(a - a0))
    again, _ = moe.moe_ffn_grouped(blk, h, ample)
    res["grouped_bitwise"] = bool(torch.equal(again,
                                              outs["moe_ffn_grouped"][0]))
    tight = dataclasses.replace(cfg, capacity_factor=MOE_TIGHT)
    out, _ = moe.moe_ffn_grouped(blk, h, tight)
    _, keep = _routing(blk, h, tight, grouped=True)
    res.update(tight_dropped_slots=int((~keep).sum()),
               tight_finite=bool(torch.isfinite(out).all()))
    log(f"[prefill] {cfg.name} MoE forms on layer 0: {json.dumps(res)}")
    for form in ("moe_ffn_grouped", "moe_ffn_dense"):
        if not (res[f"{form}_rel_diff"] < MOE_FORM_TOL
                and res[f"{form}_aux_diff"] < MOE_AUX_TOL):
            raise RuntimeError(
                f"{cfg.name}: {form} differs from moe_ffn_flat by "
                f"{res[f'{form}_rel_diff']:.3g} of the largest output "
                f"(aux {res[f'{form}_aux_diff']:.3g}) at ample capacity")
    if not res["grouped_bitwise"]:
        raise RuntimeError(f"{cfg.name}: moe_ffn_grouped gave two outputs "
                           f"for the same input")
    if not (res["tight_finite"] and res["tight_dropped_slots"] > 0):
        raise RuntimeError(f"{cfg.name}: moe_ffn_grouped at capacity "
                           f"factor {MOE_TIGHT} dropped "
                           f"{res['tight_dropped_slots']} slots, finite: "
                           f"{res['tight_finite']}")
    return res


def prefill_batch(cfg, seq: int, seed: int, device="cuda") -> dict:
    """4 sequences of ``seq`` tokens from ``seed + 1``; for vlm
    ``cfg.enc_seq`` patch embeddings and for encdec ``cfg.enc_seq`` frame
    embeddings, N(0, 1) from the same generator, in float32 (the stub
    frontends' outputs; ``_as_model_dtype`` casts them)."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, seq),
                                     generator=gen, device=device)}
    key = {"vlm": "patches", "encdec": "frames"}.get(cfg.family)
    if key:
        batch[key] = torch.randn((4, cfg.enc_seq, cfg.d_model),
                                 generator=gen, device=device)
    return batch


def _as_model_dtype(batch: dict, cfg) -> dict:
    from repro_torch.device import torch_dtype
    return {k: v if k == "tokens" else v.to(torch_dtype(cfg.dtype))
            for k, v in batch.items()}


def _decode_check(model, cfg, batch) -> dict:
    """Token by token through ``decode_step`` from a zero cache against
    ``forward``'s logits on the same tokens, through both paths: the
    state carry of the decode path (for the hybrid family the KV cache,
    the mamba conv state and the float32 SSM state) against the prefill's
    attention and log-step scan.  Raises over ``DECODE_TOL``."""
    import torch
    from repro_torch.models.cache import init_cache
    from repro_torch.models.model import decode_step, forward
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, S, device=tokens.device)
    steps = []
    t0 = time.perf_counter()
    for i in range(S):
        logits, cache = decode_step(model, cfg, cache, tokens[:, i], i)
        steps.append(logits)
    dec = torch.stack(steps, 1)
    if dec.is_cuda:
        torch.cuda.synchronize()
    res = {"layers": cfg.n_layers, "batch": B, "seq": S, "dtype": cfg.dtype,
           "decode_s": time.perf_counter() - t0, "tol": DECODE_TOL,
           "max_abs_state": {k: float(v.float().abs().max())
                             for k, v in cache.items()}}
    for impl in ("pallas", "xla"):
        full, _ = forward(model, dataclasses.replace(cfg, attn_impl=impl),
                          batch)
        res[f"{impl}_max_abs_diff"] = float((dec - full).abs().max())
    log(f"[prefill] {cfg.name} decode against forward: {json.dumps(res)}")
    worst = max(res["pallas_max_abs_diff"], res["xla_max_abs_diff"])
    if not worst < DECODE_TOL:
        raise RuntimeError(f"{cfg.name} float32: decode_step differs from "
                           f"forward by {worst:.3g}, want < {DECODE_TOL}")
    return res


def phase_prefill(seed: int, arch: str):
    """``forward`` on 4 sequences of ``PREFILL``'s length (with the vlm's
    patches or the encdec's frames): bf16 at full width and at full depth
    or ``PREFILL``'s cut, through the kernel and the plain path, then the
    same draws in float32 (for the moe family with its routing compared
    and its three MoE forms checked, ``_moe_forms``; for the hybrid family
    with decode against forward, ``_decode_check``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    from repro_torch.models.layers import rmsnorm as plain_norm
    from repro_torch.models.model import init_params
    spec = PREFILL[arch]
    base = get_config(arch)
    full_layers = base.n_layers
    if spec["layers"]:
        base = dataclasses.replace(base, n_layers=spec["layers"])
        log(f"[prefill] {arch}: full width, {base.n_layers} of "
            f"{full_layers} layers (bf16), {spec['f32_layers']} in float32")
    batch32 = prefill_batch(base, spec["seq"], seed)
    batch = _as_model_dtype(batch32, base)
    B, S = batch["tokens"].shape
    prefix = base.enc_seq if base.family == "vlm" else 0
    res = {"arch": arch, "batch": B, "seq": S, "prefix": prefix,
           "frames": base.enc_seq if base.family == "encdec" else 0,
           "layers": base.n_layers, "full_layers": full_layers}
    t_phase = time.perf_counter()

    # bf16, full depth or the cut: the main path
    cfg_k = dataclasses.replace(base, attn_impl="pallas")
    cfg_x = dataclasses.replace(base, attn_impl="xla")
    model = init_params(base, seed, device="cuda")
    if base.qkv_bias:
        _draw_biases(model, seed + 2)
    res["params"] = sum(p.numel() for p in model.parameters())
    res["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in model.parameters())
    none = {name: 0 for name in _counters()}
    norms = norms_per_forward(base)
    log(f"[prefill] {arch}: the kernel path must launch "
        f"{spec['kernel']} {base.n_layers} times (one per layer) and "
        f"rmsnorm {norms} times ({NORMS_PER_BLOCK[base.family]} per layer "
        f"+ the final norm, none for LayerNorms) per forward; the plain "
        f"path none")
    logits_k, wall_k, launches, walls_k = _forward_timed(
        model, cfg_k, batch,
        {**none, spec["kernel"]: base.n_layers, "rmsnorm": norms})
    logits_x, wall_x, _, _ = _forward_timed(model, cfg_x, batch, none)
    # the kernel path with the plain norm in place of K3: what K3 saves
    wall_p = None
    if norms:
        with mock.patch.object(blocks, "norm_fn", lambda cfg: plain_norm):
            _, wall_p, _, _ = _forward_timed(
                model, cfg_k, batch, {**none, spec["kernel"]: base.n_layers})
    for name, lg in (("bf16 pallas", logits_k), ("bf16 xla", logits_x)):
        _check_logits(name, lg, (B, S, base.vocab_size))
    res["bf16_pallas_split"] = _forward_split(model, cfg_k, batch)
    log(f"[prefill] {arch}: kernel-path forward by part "
        f"{json.dumps(res['bf16_pallas_split'])}")
    rows = B * (prefix + S)
    res.update(launches=launches,
               bf16_max_abs_logit_diff=float(
                   (logits_k.float() - logits_x.float()).abs().max()),
               bf16_top1_agreement=_top1(logits_k, logits_x),
               bf16_pallas_tok_per_s=B * S / wall_k,
               bf16_xla_tok_per_s=B * S / wall_x,
               bf16_pallas_wall_s=wall_k, bf16_pallas_wall_s_runs=walls_k,
               bf16_xla_wall_s=wall_x,
               bf16_pallas_plain_norm_wall_s=wall_p,
               rmsnorm=_norm_times(model, rows, base.d_model) if norms
               else None)
    log(f"[prefill] {arch}: launches per kernel-path forward {launches}")
    del logits_k, logits_x
    res["bf16_layerwise"] = _layerwise(model, base, batch, spec["check"])
    res["bf16_depth_1"] = _depth_agreement(model, base, batch, 1)
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
    if base.qkv_bias:
        _draw_biases(model32, seed + 2)
    res["f32_depth"] = [_depth_agreement(model32, cfg32, batch32, n)
                        for n in spec["depths"]]
    res["f32_layerwise"] = _layerwise(model32, cfg32, batch32, spec["check"])
    if base.family == "moe":
        res["f32_moe_forms"] = _moe_forms(model32, cfg32, batch["tokens"])
    if base.family == "hybrid":
        short = {k: v[:, :DECODE_CHECK_SEQ] if k == "tokens" else v
                 for k, v in batch32.items()}
        res["f32_decode"] = _decode_check(model32, cfg32, short)
    del model32
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    log("[prefill] " + json.dumps(res))
    log(f"[prefill] {arch}: phase took {res['phase_s']:.1f} s")
    if base.family == "moe":
        moved = max(res["f32_layerwise"]["routed_differently"])
        if not moved <= MAX_ROUTED_DIFFERENTLY * B * S:
            raise RuntimeError(
                f"{arch} float32: the kernel and plain paths route {moved} "
                f"of {B * S} tokens differently at a layer, want at most "
                f"{MAX_ROUTED_DIFFERENTLY:.1%}")
    one = res["f32_depth"][0]["top1"]
    if not one >= 0.99:
        raise RuntimeError(f"{arch} float32, one layer: kernel and plain "
                           f"paths agree on top-1 at {one:.4f} of "
                           f"positions, want >= 0.99")
    worst = max(res["f32_layerwise"]["block_rel_diff"])
    if not worst < 2e-4:
        alike = " on the tokens routed alike" * (base.family == "moe")
        raise RuntimeError(f"{arch} float32 layer outputs of the kernel and "
                           f"plain paths differ{alike} by {worst:.3g} of "
                           f"their largest value, want < 2e-4")
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
# phases 3, 5 and 14: serve
# ---------------------------------------------------------------------------

def phase_serve(seed: int, arch: str, layers: int = None):
    """8 requests of 32-96 prompt tokens, 32 new tokens each, on 4 slots,
    with the model cut to ``layers`` (None: full depth).  The engine
    prefills and decodes through ``decode_step``, which launches no kernel
    (as in the JAX package; the moe family's decode takes the form
    ``moe_ffn`` picks at S = 1); every count must read 0."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.serve_step import Request, ServingEngine
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
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
    res = {"arch": arch, "layers": cfg.n_layers, "requests": len(done),
           "prompt_tokens": int(sum(
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
    (REF_ROUNDS_FAULTED).  Returns the summary and the faulted cuda run,
    which phase obs repeats under the observer."""
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
            faulted = runs["cuda"]
    return out, faulted


def phase_events():
    """``simulate_events`` of the fig5 trace of EVENT_JOBS jobs on its grown
    cluster under FAULT_MODEL, with ``solver="cuda"`` and ``"numpy"``:
    every result field but host time equal (average JCT, makespan, each
    finish time, evictions, lost GPU-seconds, events, consults, each
    interval record); K4 and K5 launched by the cuda run only; the
    events, consults and evictions those of the JAX package, its average
    JCT and makespan within REF_REL_TOL (REF_EVENTS).  Reports each
    solver's wall and seconds a consult, K4's and K5's launches, K4's job
    buckets, the PriceStates built, and from ``torch.profiler``'s trace
    of the cuda run (device activity only) the device time of K4, K5 and
    all the device's work, and that work's share of that run's wall.
    Returns that summary and the cuda run's result fields, which phase
    env's episode must reproduce."""
    from repro_torch.sim.faults import FailureModel
    jobs, cluster, _ = fig5_round(EVENT_JOBS, "grown")
    model = FailureModel(**FAULT_MODEL)
    runs = {s: run_sim("events", s, jobs, cluster, model,
                       profile=s == "cuda")
            for s in ("cuda", "numpy")}
    windows = model.sample(cluster)
    out = {"jobs": EVENT_JOBS, "windows": len(windows),
           "spot_windows": sum(w.kind == "spot" for w in windows),
           **_summary(runs)}
    log("[events] " + json.dumps(out))
    _check_pair("events", runs)
    res = runs["numpy"]["res"]
    _check_reference("events", res, REF_EVENTS, {
        "n_events": res.n_events, "sched_calls": res.sched_calls,
        "evictions": res.evictions})
    return out, runs["cuda"]["fields"]


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
    wall.  Returns the summary and the faulted cuda run, which phase obs
    repeats under the observer."""
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
    faulted = runs["cuda"]
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
    return out, faulted


def _sync(device):
    """``torch.cuda.synchronize`` where ``device`` (None: the card) is the
    card, else a no-op: the env phase's helpers also run on the CPU."""
    import torch
    if device is None or torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def check_obs(obs, cp, env):
    """One env observation against the engine's state at consult ``cp``:
    queue rows plus running rows are the active jobs, the queue is the
    engine's own count, ``0 <= free <= capacity`` on every key, and the
    price is finite and positive on up nodes and ``+inf`` on down ones."""
    import numpy as np
    active = {j.job_id for j in env._jobs
              if not j.is_done() and j.arrival <= cp.t}
    rows = set(obs["queue_ids"].tolist()) | set(obs["running_ids"].tolist())
    if (len(obs["queue_ids"]) + len(obs["running_ids"]) != len(active)
            or rows != active):
        raise RuntimeError(f"env t={cp.t}: {len(obs['queue_ids'])} queued "
                           f"+ {len(obs['running_ids'])} running rows, "
                           f"{len(active)} active jobs")
    if len(obs["queue_ids"]) != cp.queue_len:
        raise RuntimeError(f"env t={cp.t}: {len(obs['queue_ids'])} queued "
                           f"rows, the engine counts {cp.queue_len}")
    if not ((obs["free"] >= 0.0).all()
            and (obs["free"] <= obs["capacity"]).all()):
        raise RuntimeError(f"env t={cp.t}: free outside [0, capacity]")
    down = np.isin(env._node_of_key, sorted(cp.down))
    price = obs["price"]
    if not ((np.isfinite(price[~down]) & (price[~down] > 0.0)).all()
            and np.isposinf(price[down]).all()):
        raise RuntimeError(f"env t={cp.t}: price not finite and positive "
                           f"on up nodes and +inf on down nodes")


def check_rewards(res, rewards):
    """Where every job finished, the episode's neg_jct rewards sum to
    -sum(JCT)/3600 within REF_REL_TOL; returns whether that applied."""
    if any(j.finish_time is None for j in res.jobs):
        return False
    want = -sum(j.finish_time - j.arrival for j in res.jobs) / 3600.0
    if abs(sum(rewards) - want) > REF_REL_TOL * abs(want):
        raise RuntimeError(f"env: neg_jct rewards sum to {sum(rewards)!r}, "
                           f"-sum(JCT)/3600 is {want!r}")
    return True


def run_env(jobs, cluster, faults, solver: str, device=None,
            profile: bool = False) -> dict:
    """One ``run_policy`` episode of ``HadarScheduler(solver, device)``
    over ``ClusterSchedulingEnv(jobs, cluster, faults=faults,
    reward="neg_jct")`` with price observations, each observation held by
    ``check_obs`` as it is built; the launch counts set to 0 just before
    the episode and read just after.  Reports the wall, the steps, the
    host time spent building observations (``obs_s``, the checks not
    included) and, with ``profile``, the device time of K4, K5 and all
    the device's work as in ``run_sim`` (needs the card)."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity
    from repro_torch.core.hadar import HadarScheduler
    from repro_torch.env import ClusterSchedulingEnv, run_policy
    from repro_torch.sim.metrics import result_fields
    env = ClusterSchedulingEnv(jobs, cluster, faults=faults,
                               reward="neg_jct", price_obs=True)
    sched = HadarScheduler(solver=solver, device=device)
    observe = env._observe
    obs_s, checked = [0.0], [0]

    def observed(cp):
        t0 = time.perf_counter()
        obs = observe(cp)
        obs_s[0] += time.perf_counter() - t0
        check_obs(obs, cp, env)
        checked[0] += 1
        return obs
    env._observe = observed
    sync = _sync(device)
    prof = (torch.profiler.profile(activities=[ProfilerActivity.CUDA])
            if profile else contextlib.nullcontext())
    sync()
    zero_launches()
    with prof:
        t0 = time.perf_counter()
        res, rewards = run_policy(env, sched)
        sync()
        wall = time.perf_counter() - t0
    launches = read_launches()
    out = {"res": res, "rewards": rewards, "fields": result_fields(res),
           "wall_s": wall, "steps": len(rewards), "obs_s": obs_s[0],
           "obs_checked": checked[0], "launches": launches}
    if profile:
        out.update(_device_ms(prof))
        out["device_share"] = out["device_ms"] / 1e3 / wall
    return out


def compare_rows(sanitize: bool, policies):
    """``repro_torch.env.compare.compare`` of COMPARE_JOBS fig5 jobs on
    ``simulation_cluster()`` under FAULT_MODEL in event mode, solver
    cuda, with
    ``REPRO_SANITIZE`` set to ``sanitize`` for the call and restored
    after; each policy's run timed and its launches counted (set to 0
    just before the run, read just after).  Returns the table and
    {policy: {"wall_s", "launches"}}."""
    import os
    from repro_torch.core.trace import philly_trace, simulation_cluster
    import repro_torch.env.compare as cmp
    from repro_torch.sim.faults import FailureModel
    sync = _sync(None)
    runs = {}
    real = cmp.run_one

    def timed(name, *a, **kw):
        sync()
        zero_launches()
        t0 = time.perf_counter()
        res = real(name, *a, **kw)
        sync()
        runs[name] = {"wall_s": time.perf_counter() - t0,
                      "launches": read_launches()}
        return res
    old = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1" if sanitize else "0"
    try:
        with mock.patch.object(cmp, "run_one", timed):
            doc = cmp.compare(philly_trace(COMPARE_JOBS, seed=1),
                              simulation_cluster(), policies, mode="event",
                              faults=FailureModel(**FAULT_MODEL),
                              solver="cuda",
                              trace_name=f"fig5(n={COMPARE_JOBS}, seed=1)")
    finally:
        if old is None:
            os.environ.pop("REPRO_SANITIZE")
        else:
            os.environ["REPRO_SANITIZE"] = old
    return doc, runs


def check_compare(doc, runs):
    """The sanitized table: valid, each row that of the JAX package
    (REF_COMPARE: strings and integers exactly, floats within
    REF_REL_TOL), Hadar's TTD below every blind policy's; K4 and K5
    launched by the runs (``compare_rows``) of COMPARE_KERNEL_POLICIES and
    no kernel by any other's."""
    import repro_torch.env.compare as cmp
    probs = cmp.validate_table(doc)
    if probs:
        raise RuntimeError(f"env compare: invalid table: {probs}")
    rows = doc["policies"]
    if [r["policy"] for r in rows] != [r["policy"] for r in REF_COMPARE]:
        raise RuntimeError("env compare: the policies differ from the JAX "
                           "package's table")
    for got, want in zip(rows, REF_COMPARE):
        for key, value in want.items():
            ok = (abs(got[key] - value) <= REF_REL_TOL * abs(value)
                  if isinstance(value, float) else got[key] == value)
            if not ok:
                raise RuntimeError(f"env compare {want['policy']}: {key} "
                                   f"{got[key]!r}, the JAX package "
                                   f"{value!r}")
    by = {r["policy"]: r for r in rows}
    blind = [p for p in cmp.BLIND_POLICIES if p in by]
    if not blind or any(by["hadar"]["ttd_hours"] >= by[p]["ttd_hours"]
                        for p in blind):
        raise RuntimeError("env compare: Hadar's TTD is not below every "
                           "blind policy's")
    for name, run in runs.items():
        got = run["launches"]
        want = name in COMPARE_KERNEL_POLICIES
        if bool(got["find_alloc"]) != want or \
                bool(got["commit_scan"]) != want or \
                any(v for k, v in got.items()
                    if k not in ("find_alloc", "commit_scan")):
            raise RuntimeError(f"env compare {name}: launches {got}")


def phase_env(events_fields):
    """The scheduling env on the card.  (a) ``run_policy`` of
    ``HadarScheduler(solver="cuda")`` through ``ClusterSchedulingEnv`` on
    phase events' trace, cluster and failure model, reward neg_jct, price
    observations on, traced by ``torch.profiler`` (device activity only):
    the result equal to phase events' cuda ``simulate_events`` result
    (``events_fields``) in every field but host time, K4 and K5 launched,
    every observation consistent (``check_obs``), the rewards summing to
    -sum(JCT)/3600 where every job finishes.  (b) The policy-comparison
    table under the sanitizer, solver cuda (``compare_rows``), held to
    the JAX package's (``check_compare``), and its Hadar and HadarE runs
    once more without the sanitizer: equal rows, each policy's wall."""
    from repro_torch.env.compare import DEFAULT_POLICIES
    from repro_torch.sim.faults import FailureModel
    jobs, cluster, _ = fig5_round(EVENT_JOBS, "grown")
    run = run_env(jobs, cluster, FailureModel(**FAULT_MODEL), "cuda",
                  profile=True)
    out = {"episode": {k: v for k, v in run.items()
                       if k not in ("res", "rewards", "fields")}}
    out["episode"].update(s_per_step=run["wall_s"] / max(1, run["steps"]),
                          obs_share=run["obs_s"] / run["wall_s"],
                          reward_sum=sum(run["rewards"]))
    log("[env] episode " + json.dumps(out["episode"]))
    if run["fields"] != events_fields:
        raise RuntimeError("env: the episode's result differs from phase "
                           "events' cuda simulate_events result")
    got = run["launches"]
    if not (got["find_alloc"] and got["commit_scan"]):
        raise RuntimeError(f"env: episode launches {got}")
    out["episode"]["rewards_telescoped"] = check_rewards(run["res"],
                                                         run["rewards"])
    doc, runs = compare_rows(True, DEFAULT_POLICIES)
    out["compare"] = {"rows": doc["policies"], "runs": runs}
    log("[env] compare " + json.dumps(runs))
    check_compare(doc, runs)
    plain, plain_runs = compare_rows(False, COMPARE_KERNEL_POLICIES)
    out["compare"]["unsanitized_runs"] = plain_runs
    log("[env] compare unsanitized " + json.dumps(plain_runs))
    want = [r for r in doc["policies"]
            if r["policy"] in COMPARE_KERNEL_POLICIES]
    if plain["policies"] != want:
        raise RuntimeError("env compare: the unsanitized rows differ from "
                           "the sanitized ones")
    return out


def run_observed(engine: str, solver: str, jobs, cluster, faults, out_dir,
                 device=None, **kw) -> dict:
    """One run of ``simulate_rounds`` or HadarE's ``simulate_hadare``
    (``engine`` "rounds" or "hadare") with ``HadarScheduler(solver,
    device)`` under ``repro_torch.obs.session``, which writes its trace,
    decision log and metrics into ``out_dir``; the launch counts set to 0
    just before the run and read just after.  Returns the result, its
    fields, the wall (one host-clock sample, the files' writing not
    included), the launches and the three files read back."""
    from repro_torch import obs
    from repro_torch.core.hadar import HadarScheduler
    from repro_torch.core.types import clone_jobs
    from repro_torch.obs.explain import load_jsonl
    from repro_torch.sim import adapters
    from repro_torch.sim import engine as eng
    from repro_torch.sim.metrics import result_fields
    jobs = clone_jobs(jobs)
    sched = HadarScheduler(solver=solver, device=device)
    paths = {k: str(Path(out_dir) / f"{engine}_{solver}_{k}.{ext}")
             for k, ext in (("trace", "json"), ("decisions", "jsonl"),
                            ("metrics", "json"))}
    sync = _sync(device)
    sync()
    zero_launches()
    with obs.session(trace_path=paths["trace"],
                     decisions_path=paths["decisions"],
                     metrics_path=paths["metrics"]):
        t0 = time.perf_counter()
        if engine == "hadare":
            res = adapters.simulate_hadare(jobs, cluster, scheduler=sched,
                                           faults=faults, **kw)
        else:
            res = eng.simulate_rounds(sched, jobs, cluster, faults=faults,
                                      **kw)
        sync()
        wall = time.perf_counter() - t0
    launches = read_launches()
    return {"res": res, "fields": result_fields(res), "wall_s": wall,
            "launches": launches,
            "trace": json.loads(Path(paths["trace"]).read_text()),
            "decisions": load_jsonl(paths["decisions"]),
            "metrics": json.loads(Path(paths["metrics"]).read_text())}


def obs_counts(run: dict) -> dict:
    """The counts of an observed run that REF_OBS holds: decisions,
    evictions, consults, faults, completions, PriceState operations, and
    the trace's hadare.consolidation instants."""
    counters = run["metrics"]["counters"]
    out = {k: v for k, v in sorted(counters.items())
           if k in ("consults", "decisions", "jobs_completed")
           or k.startswith(("faults.", "pricestate_"))}
    out["hadare.consolidation"] = sum(
        1 for e in run["trace"]["traceEvents"]
        if e.get("name") == "hadare.consolidation")
    return out


def _interval_spans(name: str, run: dict, round_len: float) -> int:
    """The sim-track ``interval`` spans against the result's round records:
    one span for each record but the fast-forwarded replicas, bitwise in
    ``ts`` and ``dur``, with the record's own figures.  Returns how many
    records were held."""
    from repro_torch.obs.trace import SIM_PID
    sim = [e for e in run["trace"]["traceEvents"]
           if e.get("pid") == SIM_PID and e.get("ph") == "X"]
    spans = [e for e in sim if e["name"] == "interval"]
    skips = {e["ts"]: e["args"]["rounds"] for e in sim
             if e["name"] == "fast_forward"}
    recs, i = [], 0
    rounds = run["res"].rounds
    while i < len(rounds):
        skip = skips.pop(rounds[i].t * 1e6, 0)
        if skip:
            i += skip
            continue
        recs.append(rounds[i])
        i += 1
    if skips or len(spans) != len(recs):
        raise RuntimeError(f"obs {name}: {len(spans)} interval spans for "
                           f"{len(recs)} records, {len(skips)} "
                           f"fast-forwards unmatched")
    for e, r in zip(spans, recs):
        a = e["args"]
        if (e["ts"] != r.t * 1e6 or e["dur"] != round_len * 1e6
                or (a["gru"], a["cru"], a["running"], a["waiting"],
                    a["changed"]) != (r.gru, r.cru, r.running, r.waiting,
                                      r.changed)):
            raise RuntimeError(f"obs {name}: the interval span at ts "
                               f"{e['ts']} differs from its record at t "
                               f"{r.t}")
    return len(recs)


def _same_runner_up(a, b) -> bool:
    """Two runner-ups: equal but for the payoff, which may differ by one
    ulp (K5's win2_pay gate allows as much)."""
    if a is None or b is None:
        return a is b
    keys = ("kind", "node", "prefix", "n_servers")
    return ([a.get(k) for k in keys] == [b.get(k) for k in keys]
            and abs(a["payoff"] - b["payoff"])
            <= math.ulp(max(abs(a["payoff"]), abs(b["payoff"]))))


def check_observed(name: str, run: dict, plain: dict, numpy_run: dict,
                   want: dict, round_len: float) -> dict:
    """An observed cuda run against the same run unobserved (``plain``:
    its fields and launches), against an observed numpy run of the same
    trace, and against the JAX package's counts (``want``): the result
    equal in every field but host time, the launches equal, the trace
    valid, its interval spans the records (``_interval_spans``), every
    logged unit price Eq. 5 of its logged inputs bitwise, no runner-up
    above its winner, the decision log the numpy run's record by record
    (but for ``solver``, and runner-up payoffs within one ulp), and the
    counts ``want``.  Returns what it read."""
    from repro_torch.obs.trace import summarize_trace, validate_trace
    if run["fields"] != plain["fields"]:
        raise RuntimeError(f"obs {name}: the observed result differs from "
                           f"the unobserved one")
    if run["launches"] != plain["launches"]:
        raise RuntimeError(f"obs {name}: launches {run['launches']}, "
                           f"unobserved {plain['launches']}")
    problems = validate_trace(run["trace"])
    if problems:
        raise RuntimeError(f"obs {name}: invalid trace: {problems[:3]}")
    held = _interval_spans(name, run, round_len)
    runner_ups = 0
    for rec in run["decisions"]:
        for row in rec.get("alloc", []):
            price = row["u_min"] * (row["u_max"] / row["u_min"]) ** (
                row["gamma"] / max(row["cap"], 1))
            if price != row["unit_price"]:
                raise RuntimeError(f"obs {name}: job {rec['job']} at "
                                   f"t={rec['t']}: unit price "
                                   f"{row['unit_price']!r}, Eq. 5 {price!r}")
        ru = rec.get("runner_up")
        if ru:
            runner_ups += 1
            if ru["payoff"] > rec["payoff"]:
                raise RuntimeError(f"obs {name}: job {rec['job']} at "
                                   f"t={rec['t']}: runner-up payoff above "
                                   f"the winner's")
    ours, theirs = run["decisions"], numpy_run["decisions"]
    if len(ours) != len(theirs):
        raise RuntimeError(f"obs {name}: {len(ours)} decision records, the "
                           f"numpy run {len(theirs)}")
    ulp_off = 0
    for a, b in zip(ours, theirs):
        rest = ("solver", "runner_up")
        if ({k: v for k, v in a.items() if k not in rest}
                != {k: v for k, v in b.items() if k not in rest}
                or not _same_runner_up(a.get("runner_up"),
                                       b.get("runner_up"))):
            raise RuntimeError(f"obs {name}: job {a['job']} at t={a['t']}: "
                               f"the decision record differs from the "
                               f"numpy run's")
        if a.get("runner_up") and a["runner_up"] != b["runner_up"]:
            ulp_off += 1
    counts = obs_counts(run)
    if counts != want:
        raise RuntimeError(f"obs {name}: counts {counts}, the JAX package "
                           f"{want}")
    summary = summarize_trace(run["trace"])
    return {"records": len(ours), "runner_ups": runner_ups,
            "runner_up_payoffs_one_ulp_off": ulp_off,
            "intervals_held": held, "counts": counts,
            "kernel_shapes": run["metrics"]["counters"].get(
                "kernel_shapes", 0),
            "spans": {k: summary.get(f"wall-clock/{k}", {"count": 0,
                                                         "total_ms": 0.0})
                      for k in OBS_SPANS}}


def phase_obs(rounds_plain: dict, hadare_plain: dict) -> dict:
    """Observability on the card: phase simulate's faulted round run of
    FAULT_ROUND_JOBS and phase hadare's run of HADARE_JOBS parents, each
    again under ``repro_torch.obs.session`` with ``solver="cuda"`` and
    FAULT_MODEL, its files in a temporary directory, and once more with
    ``solver="numpy"``: each held by ``check_observed`` against the
    unobserved cuda run that phase handed on (``rounds_plain``,
    ``hadare_plain``), the numpy run and REF_OBS.  Reports each run's
    observed and unobserved wall (one host-clock sample each) and the
    trace's totals of the consult's spans (OBS_SPANS)."""
    import tempfile
    from repro_torch.sim.faults import FailureModel
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, n, plain in (("rounds", FAULT_ROUND_JOBS, rounds_plain),
                               ("hadare", HADARE_JOBS, hadare_plain)):
            jobs, cluster, _ = fig5_round(n, "grown")
            runs = {s: run_observed(name, s, jobs, cluster,
                                    FailureModel(**FAULT_MODEL), tmp,
                                    round_len=OBS_ROUND)
                    for s in ("cuda", "numpy")}
            row = check_observed(name, runs["cuda"], plain, runs["numpy"],
                                 REF_OBS[name], OBS_ROUND)
            row.update(jobs=n, launches=runs["cuda"]["launches"],
                       wall_s=runs["cuda"]["wall_s"],
                       unobserved_wall_s=plain["wall_s"],
                       numpy_wall_s=runs["numpy"]["wall_s"])
            log(f"[obs] {name} " + json.dumps(row))
            out[name] = row
    return out


# ---------------------------------------------------------------------------
# phases train, train_rwkv, train_families, train_scheduled
# ---------------------------------------------------------------------------

# The optimizer of the full-size train phases: AdamW, a 2-step warmup into
# a cosine over the 8 steps, decay 0.1, no clip.  At the random init the
# llama3.2-1b gradient's global norm is ~1e11 (on both paths; the JAX
# package's own gradient grows as fast with depth: its tied embedding's
# input path through 16 unscaled layers): clipped to 1.0, every other
# gradient falls below Adam's eps and the loss did not move in 8 steps at
# lr 5e-4 on an H100.
TRAIN_OC = dict(lr=1e-3, warmup_steps=2, total_steps=8, weight_decay=0.1,
                grad_clip=float("inf"))
TRAIN_STEPS = 8      # steps of the kernel path on one batch (gate 4)
TRAIN_TIMED = 5      # the last five of them give the median step time
# Per train phase: the model, its depth (None: full), the tokens a
# sequence (4 sequences), the float32 depth-2 model's sequence (gate 2),
# and how many plain-path steps are timed.  Cuts: rwkv6-7b 8 of 32 layers
# (16 bytes a parameter of training state: bf16 weights and grads,
# float32 moments and clipped grads; 7.6B parameters would not fit the
# card's 80 GB, 8 layers are 2.29B); its float32 gate at 256 tokens and
# one timed plain step (the plain scan is a 1024-step Python loop under
# autograd).
TRAIN = {"llama3.2-1b": {"kernel": "flash_attention", "layers": None,
                         "seq": 1024, "f32_seq": 1024, "plain_steps": 6},
         "rwkv6-7b": {"kernel": "rwkv6_scan", "layers": 8, "seq": 1024,
                      "f32_seq": 256, "plain_steps": 1}}
# gate 2, in float32 at depth 2 (deeper, the random init makes the two
# paths chaotic): each parameter's gradient through the kernel path
# against a float64 gradient (the plain path on a float64 copy of the
# model), its max abs error within TRAIN_F32_GRAD_TOL of the largest
# |float64 gradient| or within F64_FACTOR times the float32 plain path's
# own error.  The init's near-argmax softmax makes wq's and wk's gradients
# sensitive to the order of float32 sums: K1 and the einsum path rounded
# blocks.0.wq's apart by 1.6e-3 of its largest value on an H100.
TRAIN_F32_GRAD_TOL = 1e-3


def train_launches(cfg) -> dict:
    """The launches of one kernel-path train step: each block's kernel and
    norms once in the forward, again in the backward's recompute when
    ``cfg.remat`` checkpoints the blocks, and each backward kernel once a
    block (and the final norm's)."""
    L = cfg.n_layers
    want = {name: 0 for name in _counters()}
    kern = "rwkv6_scan" if cfg.family == "ssm" else "flash_attention"
    again = 2 if cfg.remat else 1
    want[kern] = L * again
    want[kern + "_bwd"] = L
    norms = norms_per_forward(cfg)
    if norms:
        want["rmsnorm"] = norms + (again - 1) * (norms - 1)
        want["rmsnorm_bwd"] = norms
    return want


@contextlib.contextmanager
def _checked_backward(out: dict):
    """While active, every K1b, K2b and K3b call is checked as it runs
    against autograd of its plain version on its own inputs (``k1b_check``
    etc.; K2b on ``K2B_LAYER_SLICE``); the gates are appended to
    ``out[kernel]``, in call order (the layers from the last)."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import rmsnorm_bwd as rmb
    from repro_torch.kernels import rwkv6_scan_bwd as rkb
    real = {"flash_attention_bwd": (fab, fab.flash_attention_bwd),
            "rwkv6_scan_bwd": (rkb, rkb.rwkv6_scan_bwd),
            "rmsnorm_bwd": (rmb, rmb.rmsnorm_bwd)}
    checks = {"flash_attention_bwd": lambda fn, *a, **kw: k1b_check(
                  *a, kw.get("causal", True), kw.get("window", 0), bwd=fn),
              "rwkv6_scan_bwd": lambda fn, *a, **kw: k2b_check(
                  *a, sl=K2B_LAYER_SLICE, bwd=fn),
              "rmsnorm_bwd": lambda fn, *a, **kw: k3b_check(*a, bwd=fn)}

    def wrap(name):
        mod, fn = real[name]

        def checked(*a, **kw):
            res = fn(*a, **kw)
            n = mod.LAUNCHES  # the check's own launches do not count
            out.setdefault(name, []).append(checks[name](fn, *a, **kw))
            mod.LAUNCHES = n
            return res
        return mock.patch.object(mod, name, checked)
    with wrap("flash_attention_bwd"), wrap("rwkv6_scan_bwd"), \
            wrap("rmsnorm_bwd"):
        yield out


def _train_batch(cfg, seq: int, seed: int) -> dict:
    """One batch of 4 sequences of ``seq`` tokens from
    ``repro_torch.data.pipeline`` (the vlm's patches and encdec's frames
    with it), on the card."""
    from repro_torch.data.pipeline import SyntheticLM, data_config
    from repro_torch.models.model import batch_tensors
    nb = next(SyntheticLM(data_config(cfg, 4, seq, seed)).batches())
    return batch_tensors(nb, cfg, "cuda")


def _train_steps(model, cfg, oc, batch, steps: int, want: dict,
                 checks: dict = None):
    """``steps`` train steps on one batch from a fresh optimizer state,
    each timed on the host's clock (the step reads its loss on the host:
    one sync) with every launch count set to 0 just before it and read
    just after, each run's counts equal to ``want``.  With ``checks``, the
    second step runs under ``_checked_backward(checks)``.  Returns
    (losses, grad norms, walls, counts, the optimizer state)."""
    import torch
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_train_step, trainable
    step = make_train_step(cfg, oc)
    st = init_opt_state(trainable(model), oc)
    losses, norms, walls = [], [], []
    for i in range(steps):
        checked = (_checked_backward(checks) if checks is not None and i == 1
                   else contextlib.nullcontext())
        torch.cuda.synchronize()
        zero_launches()  # the run starts here
        t0 = time.perf_counter()
        with checked:
            model, st, m = step(model, st, batch)
            losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
        launches = read_launches()  # ... and ends here
        norms.append(float(m["grad_norm"]))
        _check_launches(f"{cfg.name} train step ({cfg.attn_impl})", launches,
                        want)
    return losses, norms, walls, launches, st


def _train_split(model, cfg, oc, st, batch) -> dict:
    """One kernel-path train step split by CUDA events into the forward
    (``loss_fn``), the backward (``autograd.grad``, with remat's
    recompute) and the optimizer (``apply_updates`` and the write-back):
    card time from each part's first launch to its last."""
    import torch
    from repro_torch.models.model import loss_fn
    from repro_torch.train.optimizer import apply_updates
    from repro_torch.train.train_step import load_params, trainable
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ps = trainable(model)
    torch.cuda.synchronize()
    ev[0].record()
    loss, _ = loss_fn(model, cfg, batch)
    ev[1].record()
    grads = torch.autograd.grad(loss, list(ps.values()))
    ev[2].record()
    new, _, _ = apply_updates({n: p.detach() for n, p in ps.items()},
                              dict(zip(ps, grads)), st, oc)
    load_params(model, new)
    ev[3].record()
    torch.cuda.synchronize()
    return {part: ev[i].elapsed_time(ev[i + 1]) for i, part in
            enumerate(("forward_ms", "backward_ms", "optimizer_ms"))}


def _attend_f64(q, k, v, mask):
    """``models.attention.attend`` with its softmax in the inputs' dtype
    (float64 here) instead of float32: the reference of gate 2."""
    import torch
    from repro_torch.models import attention as attn
    scores = attn._grouped_scores(q, k)
    if mask is not None:
        scores = scores.masked_fill(~mask, attn.NEG_INF)
    return attn._grouped_out(torch.softmax(scores, dim=-1), v)


def _f32_grad_agreement(arch: str, seed: int, seq: int) -> dict:
    """Gate 2: the float32 model at full width and depth 2, every
    parameter's gradient through the kernel path (its K1b/K2b/K3b checked
    as they run, float32-tight) and through the plain path, each against
    the plain path's on a float64 copy of the model with its attention's
    softmax in float64 too (``_attend_f64``; the other parts the port
    computes in float32 by design, RoPE, the norms, the final log-softmax
    and rwkv's decay and scan, stay float32 there)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.train.train_step import trainable
    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    model = init_params(cfg, seed, device="cuda")
    ps = trainable(model)
    batch = _train_batch(cfg, seq, seed)
    grads, checks = {}, {}
    for impl in ("pallas", "xla", "float64"):
        c = dataclasses.replace(cfg, attn_impl="pallas" if impl == "pallas"
                                else "xla")
        if impl == "float64":
            model.double()
        with (_checked_backward(checks) if impl == "pallas"
              else mock.patch.object(attn, "attend", _attend_f64)
              if impl == "float64" else contextlib.nullcontext()):
            loss, _ = loss_fn(model, c, batch)
            grads[impl] = torch.autograd.grad(loss, list(ps.values()))
        del loss
    worst, rows = 0.0, {}
    for i, n in enumerate(ps):
        exact = grads["float64"][i]
        size = float(exact.abs().max())
        err_k = float((grads["pallas"][i].double() - exact).abs().max())
        err_x = float((grads["xla"][i].double() - exact).abs().max())
        limit = max(F64_FACTOR * err_x, TRAIN_F32_GRAD_TOL * size)
        rows[n] = {"kernel_err": err_k / max(size, 1e-300),
                   "plain_err": err_x / max(size, 1e-300),
                   "ok": err_k <= limit}
        worst = max(worst, err_k / max(limit, 1e-300))
    bad = [n for n, r in rows.items() if not r["ok"]]
    top = sorted(rows, key=lambda n: -rows[n]["kernel_err"])[:3]
    res = {"layers": 2, "seq": seq, "tol": TRAIN_F32_GRAD_TOL,
           "f64_factor": F64_FACTOR, "worst_over_limit": worst,
           "largest_errors": {n: rows[n] for n in top}, "failed": bad,
           "kernel_checks": {k: [c["ok"] for c in v]
                             for k, v in checks.items()},
           "ok": not bad and all(c["ok"] for v in checks.values()
                                 for c in v)}
    del model, grads
    torch.cuda.empty_cache()
    return res


def phase_train(seed: int, arch: str) -> dict:
    """Training at full width (``TRAIN``'s depth): ``TRAIN_STEPS``
    kernel-path steps on one batch, each with exact launch counts (gate 3)
    and a finite loss and grad norm, the last loss below the first (gate
    4); during step 2 every K1b/K2b/K3b call checked against autograd of
    its plain version on its own inputs (gate 1); the plain path timed;
    one step split by part; the float32 depth-2 gradients of the two paths
    (gate 2)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import OptConfig
    spec = TRAIN[arch]
    base = get_config(arch)
    if spec["layers"]:
        base = dataclasses.replace(base, n_layers=spec["layers"])
    cfg = dataclasses.replace(base, attn_impl="pallas")
    oc = OptConfig(**TRAIN_OC)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed, device="cuda")
    n = sum(p.numel() for p in model.parameters())
    item = model.embed.element_size()
    batch = _train_batch(cfg, spec["seq"], seed)
    B, S = batch["tokens"].shape
    reckon = {"params_gb": n * item / 1e9, "grads_gb": n * item / 1e9,
              "moments_gb": 8 * n / 1e9, "clipped_grads_gb": 4 * n / 1e9,
              "logits_f32_gb": 3 * 4 * B * S * cfg.vocab_size / 1e9}
    reckon["total_gb"] = sum(reckon.values())
    log(f"[train] {arch}: {cfg.n_layers} of {get_config(arch).n_layers} "
        f"layers, {n / 1e9:.3f}B parameters, remat {cfg.remat}, optimizer "
        f"{json.dumps(TRAIN_OC)}; reckoned memory {json.dumps(reckon)} + "
        f"the activations remat keeps")
    want = train_launches(cfg)
    log(f"[train] {arch}: a kernel-path train step must launch "
        f"{json.dumps({k: v for k, v in want.items() if v})}")
    checks = {}  # step 2's backward kernel calls, checked (gate 1)
    losses, norms, walls, launches, st = _train_steps(
        model, cfg, oc, batch, TRAIN_STEPS, want, checks)
    split = _train_split(model, cfg, oc, st, batch)
    peak = torch.cuda.max_memory_allocated()
    wall = statistics.median(walls[-TRAIN_TIMED:])
    del model, st
    gc.collect()
    torch.cuda.empty_cache()
    # the plain path on the same init
    model = init_params(dataclasses.replace(cfg, attn_impl="xla"), seed,
                        device="cuda")
    pl, pnorms, pwalls, _, _ = _train_steps(
        model, dataclasses.replace(cfg, attn_impl="xla"), oc, batch,
        spec["plain_steps"], {name: 0 for name in _counters()})
    plain_wall = statistics.median(pwalls[-TRAIN_TIMED:])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    f32 = _f32_grad_agreement(arch, seed, spec["f32_seq"])
    res = {"arch": arch, "layers": cfg.n_layers, "params": n, "batch": B,
           "seq": S, "optimizer": TRAIN_OC, "reckoned_memory": reckon,
           "launches": launches, "losses": losses, "grad_norms": norms,
           "step_ms": wall * 1e3, "step_ms_runs": [w * 1e3 for w in walls],
           "tok_per_s": B * S / wall, "plain_step_ms": plain_wall * 1e3,
           "plain_step_ms_runs": [w * 1e3 for w in pwalls],
           "plain_tok_per_s": B * S / plain_wall, "plain_losses": pl,
           "plain_grad_norms": pnorms,
           "split": split, "max_memory_allocated_gb": peak / 1e9,
           "layer_checks": {k: [{g: c[g]["max_rel_err"] for g in c
                                 if isinstance(c[g], dict)
                                 and "max_rel_err" in c[g]}
                                for c in v] for k, v in checks.items()},
           "f32_depth_2": f32,
           "phase_s": time.perf_counter() - t_phase}
    log("[train] " + json.dumps(res))
    log(f"[train] {arch}: step {wall * 1e3:.1f} ms ({B * S / wall:.0f} tok/s)"
        f", plain path {plain_wall * 1e3:.1f} ms; split {json.dumps(split)};"
        f" peak {peak / 1e9:.2f} GB; phase took {res['phase_s']:.1f} s")
    bad = [(k, i) for k, v in checks.items() for i, c in enumerate(v)
           if not c["ok"]]
    counted = {k: len(v) for k, v in checks.items()}
    if bad or counted != {k: v for k, v in want.items()
                          if k.endswith("_bwd") and v}:
        raise RuntimeError(f"train {arch}: backward kernel checks failed at "
                           f"{bad} (calls {counted}): "
                           f"{json.dumps(res['layer_checks'])}")
    if not all(math.isfinite(x) for x in losses + norms) or \
            not losses[-1] < losses[0]:
        raise RuntimeError(f"train {arch}: losses {losses}, grad norms "
                           f"{norms}")
    if not f32["ok"]:
        raise RuntimeError(f"train {arch} float32 depth 2: {json.dumps(f32)}")
    return res


def phase_train_families(seed: int) -> dict:
    """One kernel-path train step of each of the ten configs at
    ``reduced(max_d_model=128)`` (float32, 2 layers, head dim 32) on 4 x
    64 tokens from ``data.pipeline``: a finite loss, every parameter
    tensor of the step's trainable set still finite and some moved, and
    the launches equal to ``train_launches``."""
    import torch
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import OptConfig
    out = {}
    t0 = time.perf_counter()
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    for arch in list_archs():
        cfg = dataclasses.replace(get_config(arch).reduced(max_d_model=128),
                                  attn_impl="pallas")
        model = init_params(cfg, seed, device="cuda")
        before = [p.detach().clone() for p in model.parameters()]
        losses, _, walls, launches, _ = _train_steps(
            model, cfg, oc, _train_batch(cfg, 64, seed), 1,
            train_launches(cfg))
        moved = sum(not torch.equal(a, p) for a, p in
                    zip(before, model.parameters()))
        finite = all(bool(torch.isfinite(p).all())
                     for p in model.parameters())
        out[arch] = {"loss": losses[0], "wall_s": walls[0],
                     "params_moved": moved, "param_tensors": len(before),
                     "launches": {k: v for k, v in launches.items() if v}}
        log(f"[train_families] {arch}: {json.dumps(out[arch])}")
        if not (math.isfinite(losses[0]) and moved and finite):
            raise RuntimeError(f"train_families {arch}: {out[arch]}, "
                               f"finite params {finite}")
    log(f"[train_families] took {time.perf_counter() - t0:.1f} s")
    return out


def phase_train_scheduled(seed: int) -> dict:
    """``repro_torch.launch.train.run_scheduled_training`` on the card
    through the kernels (``attn_impl="pallas"``) with its three default
    archs, for hadare, hadar and gavel: the assertions of
    ``tests/test_system.py`` (HadarE's CRU 1.0; every eval loss finite and
    below its job's initial loss; HadarE's rounds at or below Hadar's),
    with the rounds, CRU, wall, eval losses and launches of each run."""
    import torch
    from repro_torch.launch import train as lt
    archs = ["llama3.2-1b", "rwkv6-7b", "qwen3-moe-235b-a22b"]
    init = {a: lt.RealJob(i, a, 48, seed=seed + i, device="cuda",
                          attn_impl="pallas").eval_loss()
            for i, a in enumerate(archs)}
    out = {"initial_eval_losses": init}
    for sched in ("hadare", "hadar", "gavel"):
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        res = lt.run_scheduled_training(sched, archs=archs, seed=seed,
                                        verbose=False, device="cuda",
                                        attn_impl="pallas")
        wall = time.perf_counter() - t0
        launches = read_launches()
        out[sched] = {k: res[k] for k in ("rounds", "cru", "wall_seconds",
                                          "mean_finish_round", "eval_losses",
                                          "throughput_coverage")}
        out[sched].update(wall_s=wall, launches={k: v for k, v in
                                                 launches.items() if v})
        log(f"[train_scheduled] {sched}: {json.dumps(out[sched])}")
        losses = res["eval_losses"]
        if not all(math.isfinite(losses[a]) and losses[a] < init[a]
                   for a in archs):
            raise RuntimeError(f"train_scheduled {sched}: eval losses "
                               f"{losses}, initial {init}")
        for name in ("flash_attention", "flash_attention_bwd", "rwkv6_scan",
                     "rwkv6_scan_bwd", "rmsnorm", "rmsnorm_bwd"):
            if not launches[name]:
                raise RuntimeError(f"train_scheduled {sched}: {name} never "
                                   f"launched: {launches}")
    if out["hadare"]["cru"] != 1.0:
        raise RuntimeError(f"train_scheduled: HadarE's CRU "
                           f"{out['hadare']['cru']}, want 1.0")
    if not out["hadare"]["rounds"] <= out["hadar"]["rounds"]:
        raise RuntimeError(f"train_scheduled: HadarE took "
                           f"{out['hadare']['rounds']} rounds, Hadar "
                           f"{out['hadar']['rounds']}")
    return out


# Phase mesh: the consolidation on a one-rank NCCL mesh, and the dry run.
MESH_ARCH = "llama3.2-1b"
MESH_STEPS = (3.0, 5.0)
DRYRUN_TIMEOUT = 300


def mesh_consolidate(cfg) -> dict:
    """``pod_consolidate`` of two copies of ``cfg`` (seeds 0 and 1) on
    DTensors in ``pod_consolidate_shardings``' placements over a one-rank
    ``(1, 1, 1)`` ("pod", "data", "model") mesh, against the same call on
    the plain tensors on the card: every leaf bitwise equal.  Opens a
    one-rank NCCL group on a ``FileStore`` in a temporary directory and
    destroys it.  Reports the ms of both calls (CUDA events) and the
    collectives ``CommDebugMode`` saw (none: DTensor skips a reduction
    over a mesh dim of one rank)."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch import mesh as M
    from repro_torch.launch.specs import param_shardings
    from repro_torch.models import sharding as shd
    from repro_torch.models.model import init_params
    from repro_torch.train.consolidate import (pod_consolidate,
                                               pod_consolidate_shardings)
    copies = [dict(init_params(cfg, seed=s, device="cuda")
                   .named_parameters()) for s in (0, 1)]
    stacked = {n: torch.stack([c[n].detach() for c in copies])
               for n in copies[0]}
    del copies
    steps = torch.tensor(MESH_STEPS, dtype=torch.float32, device="cuda")

    def timed(fn):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    plain, plain_ms = timed(lambda: pod_consolidate(stacked, steps))
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            mesh = M.make_host_mesh(1, 1, 1, device="cuda", pod_axis=True)
            ins, _ = pod_consolidate_shardings(param_shardings(
                init_params(cfg, device="meta"), mesh))
            dstacked = {n: DTensor.from_local(
                t, mesh, shd.to_placements(ins[n], mesh))
                for n, t in stacked.items()}
            cd = CommDebugMode()
            with cd:
                out, ms = timed(lambda: pod_consolidate(dstacked, steps))
            comms = {str(k): v for k, v in cd.get_comm_counts().items()}
            bad = [n for n in plain
                   if not torch.equal(out[n].to_local(), plain[n])]
        finally:
            dist.destroy_process_group()
    if bad:
        raise AssertionError(f"mesh pod_consolidate differs from the plain "
                             f"one on {len(bad)} leaves: {bad[:5]}")
    return {"arch": cfg.name, "leaves": len(plain), "params": sum(
        t[0].numel() for t in stacked.values()), "ms": ms,
        "plain_ms": plain_ms, "collectives": comms, "bitwise": True}


def dryrun_check(rec: dict, cfg, shape_name: str) -> dict:
    """The gates of a dry-run record of ``MESH_ARCH``: status ok; for a
    step, ``argument_size_bytes`` equal to the bytes of the port's own
    placements on the record's mesh (``launch.specs.input_specs`` on the
    axis sizes) and ``0 < flops_per_device < flops_global``; for the
    consolidation, only all-reduces, of 2 x 4 x the local element count
    of the averaged parameters."""
    from repro_torch.configs import get_shape
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.launch.specs import abstract_params, input_specs
    from repro_torch.launch.specs import param_shardings
    from repro_torch.models import sharding as shd
    if rec.get("status") != "ok":
        raise AssertionError(f"dry run {shape_name}: {rec}")
    if shape_name == "consolidate":
        mesh = {"pod": 2, "data": 16, "model": 16}
        model, params = abstract_params(cfg)
        specs = param_shardings(model, mesh)
        local = sum(math.prod(shd.local_shape(tuple(p.shape), specs[n], mesh))
                    for n, p in params.items())
        want = {"all-reduce": 2 * 4 * local, "total": 2 * 4 * local}
        if rec["collective_bytes_per_device"] != want:
            raise AssertionError(f"consolidate collectives "
                                 f"{rec['collective_bytes_per_device']}, "
                                 f"want {want}")
        return {"collectives": want, "local_elements": local,
                "trace_s": rec["trace_s"]}
    mesh = dict(zip(("pod", "data", "model")[-len(rec["mesh"].split("x")):],
                    map(int, rec["mesh"].split("x"))))
    args, specs, _ = input_specs(cfg, get_shape(shape_name), mesh)
    want = argument_bytes(args, specs, mesh)
    got = rec["memory_analysis"]["argument_size_bytes"]
    if got != want:
        raise AssertionError(f"argument bytes {got}, the placements give "
                             f"{want}")
    if not 0 < rec["flops_per_device"] < rec["flops_global"]:
        raise AssertionError(f"flops/device {rec['flops_per_device']} not "
                             f"in (0, {rec['flops_global']})")
    return {"argument_size_bytes": got, "flops_per_device":
            rec["flops_per_device"], "flops_global": rec["flops_global"],
            "trace_s": rec["trace_s"]}


def start_dryrun(argv, out_dir: str):
    """``python -m repro_torch.launch.dryrun`` started in a process of
    its own (a fake world cannot live beside this one's group), records
    into ``out_dir``."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-m",
                             "repro_torch.launch.dryrun", *argv,
                             "--out-dir", out_dir], cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_dryrun(proc, out_dir: str, name: str) -> dict:
    """Waits for ``start_dryrun``'s process (``DRYRUN_TIMEOUT``) and
    returns its one record ``name``."""
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"dry run {proc.args} exited {proc.returncode}:"
                             f" {out[-2000:]}{err[-3000:]}")
    return json.loads((Path(out_dir) / name).read_text())


def phase_mesh(seed: int) -> dict:
    """(a) ``mesh_consolidate`` of two full-width llama3.2-1b bf16 copies
    on a one-rank NCCL mesh on the card; (b) the dry run of llama3.2-1b
    ``train_4k`` on the 16x16 fake mesh (with ``--global-flops``) and its
    ``--consolidate`` on 2x16x16, each a subprocess on the host, both
    started before (a) and waited for after it, each record held by
    ``dryrun_check``.  Runs last, after every other phase."""
    import tempfile
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg = get_config(MESH_ARCH)
    with tempfile.TemporaryDirectory() as tmp:
        procs = [start_dryrun(["--arch", MESH_ARCH, "--shape", "train_4k",
                               "--global-flops"], tmp),
                 start_dryrun(["--consolidate", "--arch", MESH_ARCH], tmp)]
        try:
            out = {"consolidate_nccl": mesh_consolidate(cfg)}
            log("[mesh] consolidate " + json.dumps(out["consolidate_nccl"]))
            rec = finish_dryrun(procs[0], tmp,
                                f"{MESH_ARCH}__train_4k__pod16x16.json")
            out["dryrun_train_4k"] = dryrun_check(rec, cfg, "train_4k")
            rec = finish_dryrun(procs[1], tmp,
                                f"{MESH_ARCH}__consolidate__pod2x16x16.json")
            out["dryrun_consolidate"] = dryrun_check(rec, cfg, "consolidate")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    out["seconds"] = time.perf_counter() - t0
    log("[mesh] dry run " + json.dumps({k: out[k] for k in (
        "dryrun_train_4k", "dryrun_consolidate")}))
    log(f"[mesh] phase mesh took {out['seconds']:.1f} s")
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
    bwd_rows, bwd_main = phase_backward(args.seed)
    prefill = phase_prefill(args.seed, "llama3.2-1b")
    serve = phase_serve(args.seed, "llama3.2-1b")
    prefill_rwkv = phase_prefill(args.seed, "rwkv6-7b")
    serve_rwkv = phase_serve(args.seed, "rwkv6-7b")
    t0 = time.perf_counter()
    prefill_moe = phase_prefill(args.seed, "qwen3-moe-235b-a22b")
    serve_moe = phase_serve(args.seed, "qwen3-moe-235b-a22b",
                            PREFILL["qwen3-moe-235b-a22b"]["layers"])
    prefill_grok = phase_prefill(args.seed, "grok-1-314b")
    prefill_qwen2 = phase_prefill(args.seed, "qwen2.5-32b")
    log(f"[prefill] the phases prefill_moe, serve_moe, prefill_grok and "
        f"prefill_qwen2 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    families = {}
    for arch, name in (("hymba-1.5b", "hymba"), ("internvl2-2b", "internvl2"),
                       ("whisper-tiny", "whisper")):
        t1 = time.perf_counter()
        families[f"prefill_{name}"] = phase_prefill(args.seed, arch)
        families[f"serve_{name}"] = phase_serve(args.seed, arch)
        log(f"[prefill] phases prefill_{name} and serve_{name} took "
            f"{time.perf_counter() - t1:.1f} s")
    log(f"[prefill] the hybrid, vlm and encdec phases took "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train = phase_train(args.seed, "llama3.2-1b")
    train_rwkv = phase_train(args.seed, "rwkv6-7b")
    train_families = phase_train_families(args.seed)
    train_scheduled = phase_train_scheduled(args.seed)
    log(f"[train] the phases train, train_rwkv, train_families and "
        f"train_scheduled took {time.perf_counter() - t0:.1f} s")
    schedule = phase_schedule()
    sim, rounds_plain = phase_simulate()
    events, events_fields = phase_events()
    mini = phase_mini()
    hadare, hadare_plain = phase_hadare()
    env = phase_env(events_fields)
    obs = phase_obs(rounds_plain, hadare_plain)
    mesh = phase_mesh(args.seed)
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
    # the backward kernels: each replaces the JAX package's autodiff
    # through its plain version (there is no backward Pallas kernel); the
    # counts are those of one full-size train step
    for name, launches in (("flash_attention_bwd", train["launches"]),
                           ("rwkv6_scan_bwd", train_rwkv["launches"]),
                           ("rmsnorm_bwd", train["launches"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": "src/repro/train/train_step.py:32",
            "launches": launches[name],
            **{k: bwd_main[name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms") + (("form",) if "form" in bwd_main[name]
                                  else ())},
            "launches_per_train_step": {
                r["arch"]: r["launches"][name] for r in (train, train_rwkv)},
            "launches_per_family_step": {
                arch: r["launches"].get(name, 0)
                for arch, r in train_families.items()}})
    kernels[0]["launches_per_train_step"] = {
        r["arch"]: r["launches"]["flash_attention"] for r in (train,
                                                              train_rwkv)}
    # K1 and K3 per forward of each model path, and K1 at each config's
    # attention shape (``MODEL_ATTENTION``)
    forwards = {r["arch"]: r["launches"] for r in (
        prefill, prefill_rwkv, prefill_moe, prefill_grok, prefill_qwen2,
        *(families[f"prefill_{name}"] for name in ("hymba", "internvl2",
                                                   "whisper")))}
    for k in kernels[0], kernels[2]:
        k["launches_per_forward"] = {arch: n[k["name"]]
                                     for arch, n in forwards.items()}
    kernels[0]["model_shapes"] = {
        arch: {key: row[key] for key in ("shape", "window", "max_rel_err",
                                         "ms", "library_ms", "bound_ms")}
        for arch, (Hq, Hkv, D, S, w) in MODEL_ATTENTION.items()
        for row in rows if row.get("model_layout")
        and row["shape"] == [4, Hq, Hkv, S, D] and row["window"] == w}
    for k in kernels[-2:]:
        k["event_run_launches"] = events["cuda"]["launches"][k["name"]]
        k["hadare_run_launches"] = hadare["cuda"]["launches"][k["name"]]
        k["env_run_launches"] = env["episode"]["launches"][k["name"]]
        k["obs_run_launches"] = {name: obs[name]["launches"][k["name"]]
                                 for name in obs}
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "kernel_cases": rows,
                                   "prefill": prefill, "serve": serve,
                                   "prefill_rwkv": prefill_rwkv,
                                   "serve_rwkv": serve_rwkv,
                                   "prefill_moe": prefill_moe,
                                   "serve_moe": serve_moe,
                                   "prefill_grok": prefill_grok,
                                   "prefill_qwen2": prefill_qwen2,
                                   **families,
                                   "schedule": schedule, "simulate": sim,
                                   "events": events, "mini": mini,
                                   "hadare": hadare, "env": env,
                                   "obs": obs, "backward_cases": bwd_rows,
                                   "train": train, "train_rwkv": train_rwkv,
                                   "train_families": train_families,
                                   "train_scheduled": train_scheduled,
                                   "mesh": mesh, "kernels": kernels},
                                  indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

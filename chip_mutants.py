#!/usr/bin/env python3
"""Mutation check of the kernel gates of ``chip_smoke.py``, on one card.

    python3 chip_mutants.py [--kernels NAME,...] [--out FILE.json]

Plants one fault at a time in a copy of a kernel source from
``src/repro_torch/kernels/csrc/``, builds every copy in a temporary
directory (one ``nvcc`` each, all at once), and runs the smoke's kernel
cases through each build with the smoke's own checks:

- flash attention (K1): faults in its bf16 kernel only, run through every
  bfloat16 case of the kernel phase and ``chip_smoke.check_case`` (the
  gate and the determinism check);
- the WKV6 scan (K2): faults anywhere in the source, run through every K2
  case of the kernel phase and ``chip_smoke.rwkv_check_case`` (output,
  final state, chaining and determinism);
- RMSNorm (K3): faults anywhere in the source, run through every K3 case
  and ``chip_smoke.rms_check_case`` (output and determinism);
- the scheduler kernels (K4 ``find_alloc``, K5 ``commit_scan``): faults
  anywhere in the source, run on the fig5 tables of every size and
  topology of the kernel phase through ``chip_smoke.find_alloc_check`` and
  ``commit_scan_check`` (bitwise, twice, bitwise deterministic; K5's
  runner-up payoff within one ulp), and also on the smoke's further cases
  of each (``chip_smoke.EXTRA_K4``, ``chip_smoke.EXTRA_K5``);
- the backward kernels (K1b ``flash_attention_bwd``, K2b
  ``rwkv6_scan_bwd``, K3b ``rmsnorm_bwd``): faults anywhere in the
  source (K1b's in both its forms, and in ``hopper.cuh``, which is
  inlined into the copy), run through every case of the smoke's phase
  backward and its
  checks (``chip_smoke.k1b_check``, ``k2b_check_case``, ``k3b_check``:
  each gradient against autograd of the plain version, determinism).
  Each case's inputs and plain gradients are made once and shared by the
  builds.

The unchanged sources run first as the controls.  A fault is caught when
at least one case exceeds its limit.  Exits non-zero if a control fails or
a fault is not caught.  The repository's own kernel build is not touched.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import chip_smoke

# name -> (text in the bf16 kernel, its replacement, what the fault is)
FA_MUTANTS = {
    "skip_last_tile": (
        "kt1 = (hi + TK - 1) / TK;", "kt1 = (hi + TK - 1) / TK - 1;",
        "the key-tile loop stops one tile early"),
    "late_skip_tile": (
        "kt1 = (hi + TK - 1) / TK;", "kt1 = (hi + TK - 1) / TK - (q0 >= 512);",
        "q tiles from row 512 on skip their last key tile"),
    "causal_edge": (
        "if (causal) in = in && col <= r;",
        "if (causal) in = in && col <= r + 1;",
        "each row also attends to the next key"),
    "window_edge": (
        "if (window > 0) in = in && col > r - window;",
        "if (window > 0) in = in && col >= r - window;",
        "each windowed row attends to one key too many"),
    "ragged_keys": (
        "bool in = col < S;", "bool in = true;",
        "key columns past S enter the softmax as (zero-filled) keys"),
    "no_rescale": (
        "    o[4 * j + 0] *= alpha[0];\n    o[4 * j + 1] *= alpha[0];\n"
        "    o[4 * j + 2] *= alpha[1];\n    o[4 * j + 3] *= alpha[1];\n", "",
        "acc is not rescaled when the running max grows"),
    "wrong_stage": (
        "const uint32_t kv = sKV + stage * Gm::STAGE_BYTES;",
        "const uint32_t kv = sKV + ((stage + 1) % STAGES) * Gm::STAGE_BYTES;",
        "the consumers read the next ring stage's K and V tiles"),
    "edge_as_interior": (
        "(causal && k0 + TK - 1 > r0)", "(causal && k0 > r0)",
        "the tile on the causal diagonal skips the mask"),
    "no_log2e": (
        "const float sl2 = scale * LOG2E;", "const float sl2 = scale;",
        "exp2f takes the scaled score without the folded log2(e)"),
    "out_map_dense": (
        "a.os, 64, Gm::BOX))",
        "Strides{(long long)a.Hq * a.S * D, (long long)a.S * D, D}, 64, "
        "Gm::BOX))",
        "the output map takes dense (B,Hq,S,D) strides, not the given ones"),
}
_STEP = ("            acc[m][e] = fmaf(rr[e], st[m][4 * q + e], acc[m][e]);  "
         "// o_t reads S_{t-1}\n",
         "            st[m][4 * q + e] = fmaf(ww[e], st[m][4 * q + e], "
         "kk[e] * vj[m]);  // S_t\n")
# name -> (text in the WKV6 source, its replacement, what the fault is)
RWKV_MUTANTS = {
    "no_bonus": (
        "fmaf(v_s[c * JT + col + e], b_s[c], out)", "out",
        "the u-bonus term is dropped"),
    "output_after_update": (
        "".join(_STEP), _STEP[1] + _STEP[0],
        "o_t reads S_t instead of S_{t-1}"),
    "decay_after_add": (
        "fmaf(ww[e], st[m][4 * q + e], kk[e] * vj[m])",
        "ww[e] * (st[m][4 * q + e] + kk[e] * vj[m])",
        "the decay is applied after the kv add"),
    "w_as_bf16": (
        "const float ww[4] = {w4.x, w4.y, w4.z, w4.w};",
        "const float ww[4] = {__bfloat162float(__float2bfloat16(w4.x)), "
        "__bfloat162float(__float2bfloat16(w4.y)), "
        "__bfloat162float(__float2bfloat16(w4.z)), "
        "__bfloat162float(__float2bfloat16(w4.w))};",
        "w is rounded to bf16 on read"),
    "s0_ignored": (
        "st[n][i] = s0[sbase + (NK * kg + i) * D + 16 * n];",
        "st[n][i] = 0.f;", "the initial state S_0 is ignored"),
    "state_one_early": (
        "st[m][4 * q + e] = fmaf(ww[e], st[m][4 * q + e], kk[e] * vj[m]);",
        "st[m][4 * q + e] = t0 + c == S - 1 ? st[m][4 * q + e] : "
        "fmaf(ww[e], st[m][4 * q + e], kk[e] * vj[m]);",
        "the final state is emitted one step early"),
    "ragged_tail_dropped": (
        "const int n = min(CH, S - t0);\n    const bool more",
        "const int n = S - t0 < CH ? S - t0 - 1 : CH;\n    const bool more",
        "the last step of a ragged last chunk is dropped"),
}
RMS_MUTANTS = {
    "no_eps": ("static_cast<float>(D) + eps)", "static_cast<float>(D))",
               "eps is dropped from the mean square"),
    "mean_over_d_minus_1": (
        "static_cast<float>(D) + eps)", "static_cast<float>(D - 1) + eps)",
        "the mean square divides by D - 1"),
    "no_scale": ("return xf * inv * s;", "return xf * inv;",
                 "the scale is skipped"),
    "prefetch_unused": (
        "for (int i = 0; i < VPT; ++i) cur[i] = nxt[i];", "",
        "the prefetched row is never taken up: every row of a block is "
        "normed from the block's first row"),
    "tail_dropped": (
        "const int n = static_cast<int>(min(static_cast<long long>(ROWS), "
        "rows - r0));",
        "const int n = rows - r0 < ROWS ? 0 : ROWS;",
        "a last block with fewer than ROWS rows writes none"),
}
FIND_ALLOC_MUTANTS = {
    "prefix_one_short": (
        "const bool e = c.valid && c.rank < k;",
        "const bool e = c.valid && c.rank < k - 1;",
        "each spread prefix k takes only the types of prefix k - 1"),
    "take_row_shift": (
        "t[j] = i0 + 32 * j < N * R ? tile[i0 + 32 * j] : 0.0;",
        "t[j] = i0 + 32 * j < N * R ? tile[(i0 + 32 * j + R) % (N * R)] "
        ": 0.0;",
        "the staged take span is written one node row off"),
    "batch_last_slot": (
        "cell[j] = m < M ? cnt[m] : -1;",
        "cell[j] = m < M && j < kBatch - 1 ? cnt[m] : -1;",
        "the last key of each lane's batch keeps its take as its cost"),
    "stale_cells": (
        "for (int i = lane; i < N * R; i += 32) tile[i] = 0.0;",
        "for (int i = lane; i < N * R && b < 0; i += 32) tile[i] = 0.0;",
        "a block never zeroes its tile: a cell with no key keeps what was "
        "left in that shared memory"),
    "servers_bit_alias": (
        "atomicOr(&served[h >> 5], 1u << (h & 31));",
        "atomicOr(&served[h >> 5], 1u << (h & 15));",
        "node rows h and h + 16 of one word count as one server"),
    "count_once": (
        "atomicAdd(&cnt[key], 1);", "atomicMax(&cnt[key], 1);",
        "a key chosen for several units counts one"),
    "partial_chunk_dropped": (
        "if (p < a.L) {", "if (p < a.L - a.L % 32) {",
        "a walk never reads the pool's partial last chunk"),
    "single_ignored": (
        "a.sp_ok[o] = found >= Wi && !a.single[b] && k <= kj;",
        "a.sp_ok[o] = found >= Wi && k <= kj;",
        "a single-node job gets spread slots"),
    "beyond_kj": (
        "a.sp_ok[o] = found >= Wi && !a.single[b] && k <= kj;",
        "a.sp_ok[o] = found >= Wi && !a.single[b];",
        "prefixes past the job's usable types are offered"),
    "take_rounded_up": (
        "static_cast<int>(tile[cell[j]])",
        "static_cast<int>(ceil(tile[cell[j]]))",
        "a fractional take is priced at its next whole unit"),
    "payoff_fastest": (
        "__dsub_rn(u[jlast[h]], cost)", "__dsub_rn(u[0], cost)",
        "a packed payoff takes the utility of the fastest type"),
}
COMMIT_SCAN_MUTANTS = {
    "no_commit": (
        "      s.free_s[m] = __dsub_rn(s.free_s[m], "
        "static_cast<double>(cnt));\n      s.gamma_s[m] += cnt;\n", "",
        "the winner is not committed into the carry"),
    "mu_gate_inverted": ("const bool ok = v1 > 0.0;",
                         "const bool ok = !(v1 > 0.0);",
                         "the mu_j > 0 admission gate is inverted"),
    "stale_stage": (
        "Wn = a.W[p + 1];", "Wn = a.W[p];",
        "the gang size loaded a step ahead is the previous job's"),
    "count_skip_at_W": (
        "if (n >= Wi) { k0 = r + 1; break; }",
        "if (n > Wi) { k0 = r + 1; break; }",
        "a prefix with exactly W eligible units is counted, not walked"),
    "floor_free": ("(gamma) + ceil(free)", "(gamma) + floor(free)",
                   "a key's window holds floor(free) units, not ceil(free)"),
    "fast_by_count": (
        "if (k0 > R && static_cast<double>(s.ucap[par]) < W) {",
        "if (k0 > R) {",
        "a step whose prefixes all count fewer than W units ends without "
        "looking at its node rows' free units"),
    "sweep_past_stop": (
        "if (a.Kj[q] > 0 && !(a.W[q] >= 1.0)) atomicMin(s.stop, q);",
        "if (false) atomicMin(s.stop, q);",
        "once no unit is free, the sweep also writes the jobs that ask for "
        "none"),
    "chunk_tail_dropped": (
        "return more && (c + 1) * kChunk < a.L;",
        "return more && (c + 2) * kChunk <= a.L;",
        "a walk never takes the last pool chunk when it is partial"),
}
K1B_MUTANTS = {
    "drop_g_head": (
        "for (int g = 0; g < G; ++g) {", "for (int g = 0; g < G - (G > 1); ++g) {",
        "one of a kv head's G q heads is dropped from dk and dv"),
    "dq_no_window": (
        "p_ds(s, dp, nullptr, dSs, lse_s, dl_s, q0, k0, ty, tx, S, causal, "
        "window, scale);",
        "p_ds(s, dp, nullptr, dSs, lse_s, dl_s, q0, k0, ty, tx, S, causal, "
        "0, scale);",
        "the dq pass skips the window mask inside a key tile"),
    "no_delta": (
        "dSs[r * LDP + c] = p * (dp[i][j] - dl_s[r]);",
        "dSs[r * LDP + c] = p * dp[i][j];",
        "dS takes dP without subtracting delta = dO . o"),
    "dk_unscaled": (
        "from_f32<T>(acc_k[i][j] * scale)", "from_f32<T>(acc_k[i][j])",
        "dk misses the softmax scale"),
    "causal_edge": (
        "if (causal) ok = ok && col <= row;",
        "if (causal) ok = ok && col <= row + 1;",
        "each row's gradient also takes the next key"),
    "lse_no_rescale": (
        "l[i] = l[i] * alpha + sum;", "l[i] = l[i] + sum;",
        "the log-sum-exp's running sum is not rescaled when the max grows"),
    "delta_unnormalised": (
        "delta[base + row] = su / sum;", "delta[base + row] = su;",
        "delta is sum_j exp(s - m) dP, not divided by the row's sum"),
    # the bf16 (tensor-core) form, caught by the bf16 cases
    "wg_no_delta": (
        "ds[e] = p[e] * ((dp[4 * j + e] - pv[r]) - rd[r]);",
        "ds[e] = p[e] * dp[4 * j + e];",
        "pass 1's dS takes dP without subtracting delta (pivot and rest)"),
    "wg_dq_no_delta": (
        "s[4 * j + e] = p * ((dp[4 * j + e] - pv[r]) - rd[r]);",
        "s[4 * j + e] = p * dp[4 * j + e];",
        "pass 2's dS takes dP without subtracting delta (pivot and rest)"),
    "wg_drop_head": (
        "const int g0 = z * chunk, g1 = min(G, g0 + chunk);",
        "const int g0 = z * chunk, g1 = min(G, g0 + chunk) - (G > 1);",
        "each split of pass 1 drops its last q head from dk and dv"),
    "wg_drop_split": (
        "for (int z = 0; z < splits; ++z) {",
        "for (int z = 0; z < splits - 1; ++z) {",
        "the sum of a split pass 1 leaves out the last split's partials"),
    "wg_causal_tile": (
        "const int kt0 = lo / TK, kt1 = (hi + TK - 1) / TK;",
        "const int kt0 = lo / TK, kt1 = (hi + TK - 1) / TK - causal;",
        "under a causal mask passes 0 and 2 stop one key tile early"),
    "wg_causal_q_lo": (
        "const int qt0 = q_lo / ROWS, nq",
        "const int qt0 = q_lo / ROWS + causal, nq",
        "under a causal mask pass 1 starts one q tile late"),
    "wg_no_transpose": (
        '"}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\\n}\\n"',
        '"}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\\n}\\n"',
        "the m64n64 product with A from registers reads its MN-major B "
        "(pass 2's K at D = 64) without the transpose bit"),
    "wg_no_transpose_a": (
        '"}, %32, %33, p, 1, 1, 1, 1;\\n}\\n"',
        '"}, %32, %33, p, 1, 1, 0, 1;\\n}\\n"',
        "pass 1's m64n64 products from shared memory (dV, dK at D = 64) "
        "read P and dS without the transpose bit of their A operand"),
    "wg_dk_unscaled": (
        "store_rows<D>(dk, scale, ka, &tdk, kw0, hk, b, S, wg, tid);",
        "store_rows<D>(dk, 1.f, ka, &tdk, kw0, hk, b, S, wg, tid);",
        "an unsplit pass 1 stores dk without the softmax scale"),
    "wg_u_no_rescale": (
        "u[r] = alpha * fmaf(l[r], pv[r] - pv_new, u[r]);",
        "u[r] = fmaf(l[r], pv[r] - pv_new, u[r]);",
        "pass 0's sum of p (dP - pv) is not rescaled when the row max grows"),
    "wg_no_repivot": (
        "u[r] = alpha * fmaf(l[r], pv[r] - pv_new, u[r]);",
        "u[r] = alpha * u[r];",
        "pass 0's sum of p (dP - pv) keeps the old pivot when the row max "
        "moves to another key"),
}
K2B_MUTANTS = {
    "dw_state_one_early": (
        "walk_step(c, win[c - HW]);", "walk_step(c, win[c > HW ? c - HW - 1 : 0]);",
        "the walk of the last 8 steps of a chunk reads the state one step "
        "early (the chunk-state window's index is off by one)"),
    "first_window_shifted": (
        "if (F || c < n) walk_step(c, win[c]);",
        "if (F || c < n) walk_step(c, win[c > 0 ? c - 1 : 0]);",
        "the walk of the first 8 steps reads the state one step early"),
    "dk_no_bonus": (
        "fmaf(r2.x * u2.x, dov[c], sk.x),\n          fmaf(r2.y * u2.y, dov[c], sk.y)",
        "sk.x, sk.y", "dk drops the u-bonus term"),
    "dr_no_bonus": (
        "fmaf(u2.x * k2.x, dov[c], sr.x),\n          fmaf(u2.y * k2.y, dov[c], sr.y)",
        "sr.x, sr.y", "dr drops the u-bonus term"),
    "adjoint_no_decay": (
        "adj[kk][m] = fmaf(ww[kk], adj[kk][m], rr[kk] * dd[m]);",
        "adj[kk][m] = adj[kk][m] + rr[kk] * dd[m];",
        "the adjoint is carried back without the decay"),
    "s0_ignored": (
        "const float4 s = ld4(s0 + (bh * D + i0 + 2 * kg + kk) * D + col);",
        "const float4 s = make_float4(0.f, 0.f, 0.f, 0.f);",
        "the replay starts from zero, not S_0"),
    "stale_checkpoint": (
        "ckpt + ((bh * nch + ch) * CL + rank) * (KB * D), 0, 1,",
        "ckpt + ((bh * nch + (ch > 0 ? ch - 1 : 0)) * CL + rank) * (KB * D), 0, 1,",
        "a chunk re-derives its states from the previous chunk's checkpoint"),
    "cluster_rank_dropped": (
        "for (int p = 0; p < CL; ++p) {\n          const float2 a = ld2(cluster",
        "for (int p = 0; p < CL - (CL > 1); ++p) {\n          const float2 a = ld2(cluster",
        "dv's sum over the cluster's blocks leaves out the last rank"),
    "warp_partial_dropped": (
        "for (int q = 0; q < NW; ++q) {\n        const float2 a = ld2(jp",
        "for (int q = 0; q < NW - (NW > 1); ++q) {\n        const float2 a = ld2(jp",
        "dk, dw and dr leave out the last warp's 16 value columns"),
    "du_last_batch": (
        "for (int b = 0; b < B; ++b) s +=", "for (int b = B - 1; b < B; ++b) s +=",
        "du sums only the last batch row"),
}
K3B_MUTANTS = {
    "dscale_missing_block": (
        "const int b0 = sy * per, b1 = min(b0 + per, nblocks);",
        "const int b0 = sy * per, b1 = min(b0 + per, nblocks - 1);",
        "dscale misses the last row block's partial"),
    "dx_no_mean_term": (
        "o.v[e] = from_f32<T>(r * (dyf * to_f32(sc[i].v[e])) - xf * c);",
        "o.v[e] = from_f32<T>(r * (dyf * to_f32(sc[i].v[e])));",
        "the register form's dx drops the x r^3 mean(g x) term"),
    "dscale_no_r": (
        "ds[i][e] = fmaf(dyf * xf, r, ds[i][e]);", "ds[i][e] += dyf * xf;",
        "the register form's dscale misses the 1/rms factor"),
    "no_eps": (
        "block_sum2(ss, gx, red[row & 1]);\n    const float r = 1.f / sqrtf(ss * inv_d + eps);",
        "block_sum2(ss, gx, red[row & 1]);\n    const float r = 1.f / sqrtf(ss * inv_d);",
        "the register form drops eps from the mean square"),
    "dy_next_with_x_stride": (
        "reinterpret_cast<const Vec<T>*>(dy + (r0 + row + 1) * dy_stride);",
        "reinterpret_cast<const Vec<T>*>(dy + (r0 + row + 1) * x_stride);",
        "the register form reads every dy row after a block's first with "
        "x's row stride"),
    "prefetch_unused": (
        "cx[i] = nx[i];", "cx[i] = cx[i];",
        "the prefetched row of x is never taken up: every row of a block "
        "is normed with the block's first x"),
    "tail_row_dropped": (
        "const int n = static_cast<int>(min(rpb, rows - r0));",
        "const int n = static_cast<int>(min(rpb, rows - r0 - (rows - r0 < rpb)));",
        "a last block with fewer rows than the plan's drops its last row"),
    "general_no_mean_term": (
        "dxr[i] = from_f32<T>(r * g - xf * c);", "dxr[i] = from_f32<T>(r * g);",
        "the general form's dx drops the x r^3 mean(g x) term"),
}
# kernel -> the shared header inlined into its source before faults are
# planted, so that a fault may sit in the header (K1b's in hopper.cuh)
INLINED = {"flash_attention_bwd": "hopper.cuh"}
# kernel -> its faults and the part of its source they go in (after the
# marker, or all of it)
KERNELS = {"flash_attention": (FA_MUTANTS, "// bf16: wgmma on a TMA ring"),
           "rwkv6_scan": (RWKV_MUTANTS, None),
           "rmsnorm": (RMS_MUTANTS, None),
           "find_alloc": (FIND_ALLOC_MUTANTS, None),
           "commit_scan": (COMMIT_SCAN_MUTANTS, None),
           "flash_attention_bwd": (K1B_MUTANTS, None),
           "rwkv6_scan_bwd": (K2B_MUTANTS, None),
           "rmsnorm_bwd": (K3B_MUTANTS, None)}
# the JAX package's bf16 kernel-test tolerance (tests/test_kernels.py), a
# plain max abs error, reported beside the gate for comparison
ABS_TOL = 5e-2


def mutate(src: str, old: str, new: str, mark) -> str:
    """Replace ``old`` once in the part of the source after ``mark``."""
    head, tail = src.split(mark, 1) if mark else ("", src)
    if tail.count(old) != 1:
        raise RuntimeError(f"mutation site {old!r} is not unique")
    return head + (mark or "") + tail.replace(old, new)


def build(sources: dict, workdir: Path) -> dict:
    """One nvcc per source, all at once.  sources: name -> (text of a
    ``.cu`` file, the directory its includes are found in); returns name ->
    library path.  Each build's compiler output (ptxas registers, spills)
    is kept beside it as ``<name>.log``."""
    from repro_torch.kernels import build as kbuild
    nvcc = kbuild.nvcc_path()
    procs = {}
    for name, (text, include) in sources.items():
        cu = workdir / f"{name}.cu"
        cu.write_text(text)
        lib = workdir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *kbuild.NVCC_FLAGS, "-I", str(include), "-o",
             str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        (workdir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}.cu exited {proc.returncode}:\n"
                               f"{log}")
        out[name] = lib
    return out


def swapped(kernel: str, lib: Path):
    """A context in which the wrapper of ``kernel`` (a module of
    ``repro_torch.kernels``) launches the kernel of the library at
    ``lib`` in place of the repository's build."""
    mod = importlib.import_module(f"repro_torch.kernels.{kernel}")
    return mock.patch.object(mod, "_fn", mod.bind(ctypes.CDLL(str(lib))))


_SCHED_TABLES = {}
_PLAIN = {}  # case -> what the first K5 check on it returned last
_BWD_INPUTS = {}  # (kernel, case) -> its inputs, made once
_PLAIN_GRADS = {}  # inputs' addresses and layouts -> the plain gradients


def _layout(t):
    return (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)


def _cached_plain_grads(fn, inputs, grad_out, retain=False):
    """``chip_smoke._plain_grads`` computed once per inputs: the cases'
    inputs live for the whole run, so their addresses name them."""
    if retain:
        return _REAL_PLAIN(fn, inputs, grad_out, retain)
    key = (tuple(_layout(t) for t in inputs), _layout(grad_out))
    if key not in _PLAIN_GRADS:
        _PLAIN_GRADS[key] = _REAL_PLAIN(fn, inputs, grad_out)
    return _PLAIN_GRADS[key]


_REAL_PLAIN = chip_smoke._plain_grads


def bwd_inputs(kernel: str) -> dict:
    """case -> inputs of every case of the smoke's phase backward for
    ``kernel`` (seed 0), made once."""
    import torch
    cases = {"flash_attention_bwd": chip_smoke.k1b_cases(),
             "rwkv6_scan_bwd": chip_smoke.K2B_CASES,
             "rmsnorm_bwd": chip_smoke.K3B_CASES}[kernel]
    make = {"flash_attention_bwd": chip_smoke.k1b_inputs,
            "rwkv6_scan_bwd": chip_smoke.k2b_inputs,
            "rmsnorm_bwd": chip_smoke.k3b_inputs}[kernel]
    if not any(k == kernel for k, _ in _BWD_INPUTS):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        for case in cases:
            _BWD_INPUTS[(kernel, tuple(case))] = make(case, gen)
    return {c: ins for (k, c), ins in _BWD_INPUTS.items() if k == kernel}


def sched_tables() -> dict:
    """(n, topo) -> (K4 tables, K5 tables) of the kernel phase, (kind, n)
    -> (K4 tables, None) for K4's further cases (``chip_smoke.EXTRA_K4``),
    and (kind, arg) -> (None, K5 tables) for K5's
    (``chip_smoke.EXTRA_K5``), built once."""
    if not _SCHED_TABLES:
        for n in chip_smoke.SCHED_SIZES:
            for topo in ("grown", "bursty"):
                _SCHED_TABLES[(n, topo)] = chip_smoke.sched_tables(
                    n, topo)[:2]
        for kind, n in chip_smoke.EXTRA_K4:
            _SCHED_TABLES[(kind, n)] = (chip_smoke.k4_tables(kind, n), None)
        for kind, arg in chip_smoke.EXTRA_K5:
            _SCHED_TABLES[(kind, arg)] = (None,
                                          chip_smoke.extra_tables(kind, arg))
    return _SCHED_TABLES


def run_cases(kernel: str, lib: Path) -> list:
    """The kernel's cases through the library at ``lib``, on the smoke's
    inputs (seed 0): K1's bfloat16 cases, every K2 and K3 case, or every
    K4 and K5 case of the kernel phase."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    # built before the swap: the "hadare" tables come from a run of the
    # scheduler, which must launch the repository's kernels
    tables = (sched_tables() if kernel in ("find_alloc", "commit_scan")
              else None)
    inputs = bwd_inputs(kernel) if kernel.endswith("_bwd") else None
    with swapped(kernel, lib), mock.patch.object(
            chip_smoke, "_plain_grads", _cached_plain_grads):
        if kernel == "flash_attention_bwd":
            for case, ins in inputs.items():
                errs = chip_smoke.k1b_check(*ins, case[6], case[7])
                rows.append({"case": list(case[:8]), **errs})
        elif kernel == "rwkv6_scan_bwd":
            for case, ins in inputs.items():
                errs, _ = chip_smoke.k2b_check_case(case[5], ins)
                rows.append({"case": list(case[:6]), **errs})
        elif kernel == "rmsnorm_bwd":
            for case, ins in inputs.items():
                rows.append({"case": list(case[:5]),
                             **chip_smoke.k3b_check(*ins)})
        elif kernel == "flash_attention":
            for case in chip_smoke.kernel_cases():
                if case[5] == "bfloat16":
                    errs, _ = chip_smoke.check_case(case, gen)
                    rows.append({"case": list(case[:8]), **errs})
        elif kernel == "rwkv6_scan":
            for case in chip_smoke.rwkv_cases():
                errs, _ = chip_smoke.rwkv_check_case(case, gen)
                rows.append({"case": list(case[:6]), **errs})
        elif kernel == "rmsnorm":
            for case in chip_smoke.RMS_CASES:
                errs, _ = chip_smoke.rms_check_case(case, gen)
                rows.append({"case": list(case[:5]), **errs})
        else:
            check = (chip_smoke.find_alloc_check if kernel == "find_alloc"
                     else chip_smoke.commit_scan_check)
            for case, tabs in tables.items():
                tab = tabs[0] if kernel == "find_alloc" else tabs[1]
                if tab is None:
                    continue
                if kernel == "find_alloc":
                    rows.append({"case": list(case), **check(tab)[0]})
                    continue
                res = check(tab, _PLAIN.get(case))
                _PLAIN[case] = res[4]
                rows.append({"case": list(case), **res[0]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="the kernels whose faults to plant (default: all)")
    ap.add_argument("--out", default=None,
                    help="also write every reading to this JSON file")
    args = ap.parse_args(argv)
    kernels = {k: KERNELS[k] for k in args.kernels.split(",")}
    import torch
    if not torch.cuda.is_available():
        print("chip_mutants: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build as kbuild
    sources, what = {}, {}
    for kernel, (mutants, mark) in kernels.items():
        src = (kbuild.CSRC / f"{kernel}.cu").read_text()
        if kernel in INLINED:
            head = INLINED[kernel]
            src = src.replace(f'#include "{head}"\n',
                              (kbuild.CSRC / head).read_text(), 1)
        sources[(kernel, "control")] = src
        what[(kernel, "control")] = "unchanged"
        for name, (old, new, desc) in mutants.items():
            sources[(kernel, name)] = mutate(src, old, new, mark)
            what[(kernel, name)] = desc
    report, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build({f"{k}-{n}": (text, kbuild.CSRC)
                      for (k, n), text in sources.items()}, Path(tmp))
        for (kernel, name) in sources:
            rows = run_cases(kernel, libs[f"{kernel}-{name}"])
            failing = [r for r in rows if not r["ok"]]
            rep = {"what": what[(kernel, name)], "cases": len(rows),
                   "cases_over_limit": len(failing),
                   "cases_over_abs_tol": sum(r["max_abs_err"] >= ABS_TOL
                                             for r in rows),
                   "worst_rel_err": max(r.get("max_rel_err", 0.0)
                                        for r in rows),
                   "worst_abs_err": max(r["max_abs_err"] for r in rows),
                   "worst_state_err": max(r.get("state_abs_err", 0.0)
                                          for r in rows),
                   "worst_state_rel_err": max(r.get("state_rel_err", 0.0)
                                              for r in rows),
                   "mismatched": sorted({f for r in rows
                                         for f in r.get("mismatched", [])}),
                   "caught_by": [r["case"] for r in failing], "rows": rows}
            report.setdefault(kernel, {})[name] = rep
            if bool(failing) != (name != "control"):
                bad.append(f"{kernel}/{name}")
            print(f"[mutant] {kernel:15s} {name:19s} over limit in "
                  f"{len(failing):2d} of {len(rows)} cases (max abs >= "
                  f"{ABS_TOL}: {rep['cases_over_abs_tol']:2d}); worst "
                  f"rel_err {rep['worst_rel_err']:.4g}, abs_err "
                  f"{rep['worst_abs_err']:.4g}, state_err "
                  f"{rep['worst_state_err']:.4g} (rel "
                  f"{rep['worst_state_rel_err']:.4g})"
                  + (f"; differs in {rep['mismatched']}"
                     if rep["mismatched"] else ""), flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": chip_smoke.card_line(),
                                   "limit": chip_smoke.BF16_REL_TOL,
                                   "mutants": report}, indent=1))
    if bad:
        print(f"chip_mutants: wrong verdict for {bad}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "caught": {
        kernel: sorted(mutants) for kernel, (mutants, _) in kernels.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

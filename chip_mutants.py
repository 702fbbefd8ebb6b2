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
  of each (``chip_smoke.EXTRA_K4``, ``chip_smoke.EXTRA_K5``).

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
# kernel -> its faults and the part of its source they go in (after the
# marker, or all of it)
KERNELS = {"flash_attention": (FA_MUTANTS, "// bf16: wgmma on a TMA ring"),
           "rwkv6_scan": (RWKV_MUTANTS, None),
           "rmsnorm": (RMS_MUTANTS, None),
           "find_alloc": (FIND_ALLOC_MUTANTS, None),
           "commit_scan": (COMMIT_SCAN_MUTANTS, None)}
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
    with swapped(kernel, lib):
        if kernel == "flash_attention":
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

#!/usr/bin/env python3
"""Mutation check of the bf16 flash-attention kernel's gate, on one card.

    python3 chip_mutants.py [--out FILE.json]

Plants one fault at a time in a copy of
``src/repro_torch/kernels/csrc/flash_attention.cu`` (its bf16 kernel only),
built in a temporary directory, and runs every bfloat16 case of
``chip_smoke.py``'s kernel phase through it with ``chip_smoke.gate``.  The
unchanged source runs first as the control.  A fault is caught when at least
one case exceeds the limit.  Exits non-zero if the control fails or a fault
is not caught.  The repository's own kernel build is not touched.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import chip_smoke

# name -> (text in the bf16 kernel, its replacement, what the fault is)
MUTANTS = {
    "skip_last_tile": (
        "kt < kt_end; ++kt", "kt < kt_end - 1; ++kt",
        "the key-tile loop stops one tile early"),
    "late_skip_tile": (
        "kt < kt_end; ++kt", "kt < kt_end - (q0 >= 512); ++kt",
        "q tiles from row 512 on skip their last key tile"),
    "causal_edge": (
        "if (causal) in = in && col <= row;",
        "if (causal) in = in && col <= row + 1;",
        "each row also attends to the next key"),
    "window_edge": (
        "if (window > 0) in = in && col > row - window;",
        "if (window > 0) in = in && col >= row - window;",
        "each windowed row attends to one key too many"),
    "ragged_keys": (
        "bool in = col < S;\n        if (causal)",
        "bool in = true;\n        if (causal)",
        "key columns past S enter the softmax as zero keys"),
    "no_rescale": (
        "acc[j][0] *= alpha[0];\n      acc[j][1] *= alpha[0];\n"
        "      acc[j][2] *= alpha[1];\n      acc[j][3] *= alpha[1];", "",
        "acc is not rescaled when the running max grows"),
}
BF16_MARK = "// bf16: tensor cores"
# the JAX package's bf16 kernel-test tolerance (tests/test_kernels.py), a
# plain max abs error, reported beside the gate for comparison
ABS_TOL = 5e-2


def mutate(src: str, old: str, new: str) -> str:
    """Replace ``old`` once in the bf16 part of the source."""
    head, tail = src.split(BF16_MARK, 1)
    if tail.count(old) != 1:
        raise RuntimeError(f"mutation site {old!r} is not unique in the "
                           f"bf16 kernel")
    return head + BF16_MARK + tail.replace(old, new)


def build(sources: dict, workdir: Path) -> dict:
    """One nvcc per source, all at once; returns name -> library path."""
    from repro_torch.kernels import build as kbuild
    nvcc = kbuild.nvcc_path()
    procs = {}
    for name, text in sources.items():
        cu = workdir / f"{name}.cu"
        cu.write_text(text)
        lib = workdir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *kbuild.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}.cu exited {proc.returncode}:\n"
                               f"{log}")
        out[name] = lib
    return out


def run_cases(lib: Path) -> list:
    """Every bf16 kernel-phase case through the library at ``lib``, on the
    smoke's inputs (seed 0)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    with mock.patch.object(fa, "_fn", fa.bind(ctypes.CDLL(str(lib)))):
        for case in chip_smoke.kernel_cases():
            if case[5] != "bfloat16":
                continue
            errs, _ = chip_smoke.check_case(case, gen)
            rows.append({"case": list(case[:8]), **errs})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write every reading to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_mutants: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build as kbuild
    src = (kbuild.CSRC / "flash_attention.cu").read_text()
    sources = {"control": src}
    sources.update({name: mutate(src, old, new)
                    for name, (old, new, _) in MUTANTS.items()})
    report, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, Path(tmp))
        for name, lib in libs.items():
            rows = run_cases(lib)
            failing = [r for r in rows if not r["ok"]]
            report[name] = {
                "what": MUTANTS[name][2] if name in MUTANTS else "unchanged",
                "cases": len(rows), "cases_over_limit": len(failing),
                "cases_over_abs_tol": sum(r["max_abs_err"] >= ABS_TOL
                                          for r in rows),
                "worst_rel_err": max(r["max_rel_err"] for r in rows),
                "worst_abs_err": max(r["max_abs_err"] for r in rows),
                "rows": rows}
            caught = bool(failing)
            if caught != (name != "control"):
                bad.append(name)
            print(f"[mutant] {name:15s} over limit in {len(failing):2d} of "
                  f"{len(rows)} cases (max abs >= {ABS_TOL}: "
                  f"{report[name]['cases_over_abs_tol']:2d}); worst rel_err "
                  f"{report[name]['worst_rel_err']:.4g}, abs_err "
                  f"{report[name]['worst_abs_err']:.4g} "
                  f"(limit rel {chip_smoke.BF16_REL_TOL})", flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": chip_smoke.card_line(),
                                   "limit": chip_smoke.BF16_REL_TOL,
                                   "mutants": report}, indent=1))
    if bad:
        print(f"chip_mutants: wrong verdict for {bad}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "caught": sorted(MUTANTS)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

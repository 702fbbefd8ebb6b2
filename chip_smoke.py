#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (an H100 is the target).

    python3 chip_smoke.py [--seed N] [--out FILE.json]

Builds every hand-written kernel from ``src/repro_torch/kernels/csrc`` and
drives the port of the llama3.2-1b serving path at full width and depth
with random weights from ``--seed``.  Three phases; any failure raises and
the script exits non-zero:

1. kernel  -- the flash-attention kernel against its plain PyTorch version
   (``kernels/ref.py``) on the card: the shape sweep of the JAX package's
   kernel tests, the llama3.2-1b prefill shapes and ragged S=100 and
   S=1000.  float32 is held to a max abs error of 2e-4; bfloat16 to a max
   abs error over each (batch, head, 64-row block) of 3e-2 of that block's
   largest output (``rowblock_rel_err``), so the limit follows the output's
   size along the sequence.  Times the kernel, the plain version and
   ``scaled_dot_product_attention`` (a yardstick only; the port never
   calls it).
2. prefill -- ``forward`` on 4 x 1024 tokens in bf16, once through the
   kernel (``attn_impl="pallas"``) and once through the einsum path
   (``"xla"``).  The launch count is set to 0 just before the kernel run
   and must read 16 (one per layer) just after.  At every layer the
   kernel's attention on that layer's own bf16 q, k, v is held against
   the plain version with the bf16 limit above.  The same weights drawn in
   float32: each layer's output through both paths within 2e-4 of its
   largest value, and top-1 agreement >= 99% after one layer.
3. serve   -- ``ServingEngine`` (4 slots, max_seq 256) answers 8 requests
   of 32-96 prompt tokens and 32 new tokens each.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

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


def kernel_cases():
    """(B, Hq, Hkv, S, D, dtype, causal, window, model_layout, iters) of
    every case the kernel phase checks.  The first llama case takes
    transposed (B,S,H,D) views, as ``ops.flash_attention`` passes them on
    from ``forward``; it is the main-path row of the kernels record."""
    cases = [(B, Hq, Hkv, S, D, dt, c, w, False, 10)
             for (B, Hq, Hkv, S, D) in SWEEP
             for dt in ("float32", "bfloat16") for c, w in MASKS]
    cases += [LLAMA_PREFILL + (True, 20),
              (4, 32, 8, 2048, 64, "bfloat16", True, 8192, False, 20),
              (1, 32, 8, 1000, 64, "bfloat16", True, 8192, False, 20),
              (1, 32, 8, 1000, 64, "bfloat16", False, 0, False, 10),
              (1, 32, 8, 1000, 64, "float32", False, 0, False, 10),
              (2, 4, 2, 100, 32, "bfloat16", False, 0, False, 10)]
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
    """Draw one case's inputs, run the kernel and its plain version.
    Returns (errors from ``gate``, (q, k, v, plain output)).  Model-layout cases take
    transposed views of (B,S,H,D) tensors."""
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

    q, k, v = make(Hq), make(Hkv), make(Hkv)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal, window)
    return gate(out, want, dtype), (q, k, v, want)


def kernel_case(case, gen):
    """One case: check against the plain version (raises if over the
    limit), then time the kernel, the plain version and SDPA."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, Hq, Hkv, S, D, dtype, causal, window, model_layout, iters = case
    errs, (q, k, v, want) = check_case(case, gen)
    if not errs["ok"]:
        raise RuntimeError(
            f"flash_attention disagrees with its plain version at {case[:8]}:"
            f" {errs['gated_on']} {errs[errs['gated_on']]} >= {errs['tol']}")
    lib = sdpa_call(q, k, v, causal, window)
    lib_err = float((lib().float() - want.float()).abs().max())
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                            window=window), iters)
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal,
                                                       window),
                       max(2, iters // 4))
    library_ms = cuda_ms(lib, iters)
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
        f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
        f"({bound_by}) {row['tflops']:.1f} TFLOP/s")
    return row


def phase_kernel(seed: int):
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rows = [kernel_case(case, gen) for case in kernel_cases()]
    main = next(r for r in rows if r["model_layout"])
    return rows, main


# ---------------------------------------------------------------------------
# phase 2: prefill
# ---------------------------------------------------------------------------

def _forward_timed(model, cfg, tokens):
    import torch
    from repro_torch.models.model import forward
    forward(model, cfg, {"tokens": tokens})  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = forward(model, cfg, {"tokens": tokens})
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0


def _top1(a, b) -> float:
    return float((a.argmax(-1) == b.argmax(-1)).float().mean())


def _depth_agreement(model, cfg, tokens, depth: int) -> dict:
    """Kernel path vs einsum path, forward through the first ``depth``
    layers only: top-1 agreement and max |logit difference|."""
    from types import SimpleNamespace
    from repro_torch.models.model import forward
    part = SimpleNamespace(embed=model.embed, final_norm=model.final_norm,
                           blocks=model.blocks[:depth])
    cfg = dataclasses.replace(cfg, n_layers=depth)
    lk, _ = forward(part, dataclasses.replace(cfg, attn_impl="pallas"),
                    {"tokens": tokens})
    lx, _ = forward(part, dataclasses.replace(cfg, attn_impl="xla"),
                    {"tokens": tokens})
    return {"depth": depth, "top1": _top1(lk, lx),
            "max_abs_logit_diff": float((lk.float() - lx.float()).abs().max())}


def _layerwise(model, cfg, tokens) -> dict:
    """Every layer on the same input (the einsum path's output of the
    layer before), so that nothing compounds across layers:

    - ``block_rel_diff``: the layer through both paths, max |difference|
      over max |output|;
    - ``attn``: the kernel's attention on the layer's own q, k, v (the
      model's score scale) against its plain version, by ``gate``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn
    from repro_torch.models.blocks import block_fwd
    from repro_torch.models.layers import apply_rope, rmsnorm
    win = cfg.sliding_window
    fk = block_fwd(dataclasses.replace(cfg, attn_impl="pallas"), win)
    fx = block_fwd(dataclasses.replace(cfg, attn_impl="xla"), win)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = model.embed[tokens]
    res = {"block_rel_diff": [], "attn": []}
    for blk in model.blocks:
        q, k, v = attn.qkv(blk, rmsnorm(x, blk.ln1, cfg.norm_eps))
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        res["attn"].append(gate(
            fa.flash_attention(q, k, v, causal=True, window=win),
            ref.flash_attention_ref(q, k, v, True, win), cfg.dtype))
        yk, _ = fk(blk, x, positions)
        yx, _ = fx(blk, x, positions)
        res["block_rel_diff"].append(float(
            (yk.float() - yx.float()).abs().max() / yx.float().abs().max()))
        x = yx
    return res


def phase_prefill(seed: int):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import forward, init_params
    base = get_config("llama3.2-1b")
    B, S = 4, 1024
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    tokens = torch.randint(0, base.vocab_size, (B, S), generator=gen,
                           device="cuda")
    res = {"batch": B, "seq": S}

    # bf16, full depth: the main path
    cfg_k = dataclasses.replace(base, attn_impl="pallas")
    cfg_x = dataclasses.replace(base, attn_impl="xla")
    model = init_params(base, seed, device="cuda")
    forward(model, cfg_k, {"tokens": tokens})  # warm-up
    torch.cuda.synchronize()
    fa.LAUNCHES = 0  # the main path's run starts here
    t0 = time.perf_counter()
    logits_k, _ = forward(model, cfg_k, {"tokens": tokens})
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = fa.LAUNCHES  # ... and ends here
    if launches != base.n_layers:
        raise RuntimeError(f"forward launched the kernel {launches} times, "
                           f"want {base.n_layers}")
    logits_x, wall_x = _forward_timed(model, cfg_x, tokens)
    for name, lg in (("pallas", logits_k), ("xla", logits_x)):
        if lg.shape != (B, S, base.vocab_size) or not bool(
                torch.isfinite(lg).all()):
            raise RuntimeError(f"bf16 {name} logits: shape "
                               f"{tuple(lg.shape)} or non-finite values")
    res.update(launches=launches,
               bf16_max_abs_logit_diff=float(
                   (logits_k.float() - logits_x.float()).abs().max()),
               bf16_top1_agreement=_top1(logits_k, logits_x),
               bf16_pallas_tok_per_s=B * S / wall_k,
               bf16_xla_tok_per_s=B * S / wall_x,
               bf16_pallas_wall_s=wall_k, bf16_xla_wall_s=wall_x)
    del logits_k, logits_x
    res["bf16_layerwise"] = _layerwise(model, base, tokens)
    res["bf16_depth_1"] = _depth_agreement(model, base, tokens, 1)
    del model
    torch.cuda.empty_cache()

    # The same draws in float32, where the two paths differ only by the
    # order of f32 sums.  With this random init (attention scores of std
    # ~128, near-argmax softmax) a difference that small still compounds
    # over the layers, so agreement is read against depth and per layer.
    cfg32 = dataclasses.replace(base, dtype="float32")
    model32 = init_params(cfg32, seed, device="cuda")
    res["f32_depth"] = [_depth_agreement(model32, cfg32, tokens, n)
                        for n in (1, 2, 4, 8, 16)]
    res["f32_layerwise"] = _layerwise(model32, cfg32, tokens)
    del model32
    torch.cuda.empty_cache()
    log("[prefill] " + json.dumps(res))
    one = res["f32_depth"][0]["top1"]
    if not one >= 0.99:
        raise RuntimeError(f"float32, one layer: kernel and einsum paths "
                           f"agree on top-1 at {one:.4f} of positions, "
                           f"want >= 0.99")
    worst = max(res["f32_layerwise"]["block_rel_diff"])
    if not worst < 2e-4:
        raise RuntimeError(f"float32 layer outputs of the kernel and einsum "
                           f"paths differ by {worst:.3g} of their largest "
                           f"value, want < 2e-4")
    for dt in ("bf16", "f32"):
        for i, g in enumerate(res[f"{dt}_layerwise"]["attn"]):
            if not g["ok"]:
                raise RuntimeError(
                    f"{dt} layer {i}: the kernel's attention disagrees with "
                    f"its plain version: {g['gated_on']} "
                    f"{g[g['gated_on']]} >= {g['tol']}")
    return res


# ---------------------------------------------------------------------------
# phase 3: serve
# ---------------------------------------------------------------------------

def phase_serve(seed: int):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import init_params
    from repro_torch.serve.serve_step import Request, ServingEngine
    cfg = get_config("llama3.2-1b")
    model = init_params(cfg, seed, device="cuda")
    eng = ServingEngine(cfg, model, slots=4, max_seq=256, device="cuda")
    rs = np.random.RandomState(seed)
    reqs = [Request(i, rs.randint(0, cfg.vocab_size, size=rs.randint(32, 97)),
                    32) for i in range(8)]
    n0 = fa.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    wall = time.perf_counter() - t0  # run() returns host arrays
    new = sum(len(r.out) for r in done)
    if len(done) != 8 or any(
            len(r.out) != 32 or r.out.min() < 0
            or r.out.max() >= cfg.vocab_size for r in done):
        raise RuntimeError("serve: a request did not complete with 32 "
                           "valid tokens")
    res = {"requests": len(done), "prompt_tokens": int(sum(
               len(r.prompt) for r in reqs)), "new_tokens": new,
           "wall_s": wall, "tok_per_s": new / wall,
           "kernel_launches": fa.LAUNCHES - n0}
    log("[serve] " + json.dumps(res))
    return res


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

    rows, main_row = phase_kernel(args.seed)
    prefill = phase_prefill(args.seed)
    serve = phase_serve(args.seed)

    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:65",
        "launches": prefill["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "max_rel_err": main_row["max_rel_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "kernel_cases": rows,
                                   "prefill": prefill, "serve": serve,
                                   "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

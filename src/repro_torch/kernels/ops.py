"""Dispatch over the hand-written kernels, in model layout.

A tensor on the card goes to the kernel; a tensor on the CPU goes to the
kernel's plain version in ``ref``.  Nothing is padded: each kernel takes a
ragged sequence length (or row count) itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import commit_scan as _commit
from repro_torch.kernels import find_alloc as _find
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import rwkv6_scan as _rwkv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout q:(B,S,Hq,Dh), k/v:(B,S,Hkv,Dh) -> (B,S,Hq,Dh),
    contiguous: the kernel writes it in place through the transposed view,
    so the output projection flattens the heads without a copy."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type == "cpu":
        out.transpose(1, 2).copy_(
            ref.flash_attention_ref(qt, kt, vt, causal, window))
    else:
        _fa.flash_attention(qt, kt, vt, causal=causal, window=window,
                            out=out.transpose(1, 2))
    return out


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """Model layout r/k/v/w:(B,S,H,Dh), u:(H,Dh), state:(B,H,Dh,Dh).
    Returns (out (B,S,H,Dh), new_state float32)."""
    rt, kt, vt, wt = (t.transpose(1, 2) for t in (r, k, v, w))
    if r.device.type == "cpu":
        out, s = ref.rwkv6_scan_ref(rt, kt, vt, wt, u, state)
    else:
        out, s = _rwkv.rwkv6_scan(rt, kt, vt, wt, u, state)
    return out.transpose(1, 2), s


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x (..., D), scale (D,) -> x's shape and dtype (K3)."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    return _rms.rmsnorm(x, scale, eps)


def find_alloc(*args, n_nodes: int, comm_frac: float, wmax: int):
    """FIND_ALLOC of a batch of jobs (K4); arguments and results as
    ``ref.find_alloc_ref``."""
    if args[0].device.type == "cpu":
        return ref.find_alloc_ref(*args, n_nodes, comm_frac, wmax)
    return _find.find_alloc(*args, n_nodes, comm_frac, wmax)


def commit_scan(*args, n_nodes: int, comm_frac: float, wmax: int):
    """The sequential greedy commit of a batch of jobs (K5); arguments
    and results as ``ref.commit_scan_ref``."""
    if args[0].device.type == "cpu":
        return ref.commit_scan_ref(*args, n_nodes, comm_frac, wmax)
    return _commit.commit_scan(*args, n_nodes, comm_frac, wmax)

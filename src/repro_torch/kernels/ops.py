"""Dispatch over the hand-written kernels, in model layout.

A tensor on the card goes to the kernel; a tensor on the CPU goes to the
kernel's plain version in ``ref``.  Nothing is padded: each kernel takes a
ragged sequence length (or row count) itself.  The three model kernels go
through autograd ``Function``s, so the kernel path trains: on the card K1,
K2 and K3 forward and K1b, K2b and K3b backward; on the CPU the plain
versions and their autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import commit_scan as _commit
from repro_torch.kernels import find_alloc as _find
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm_bwd as _rmsb
from repro_torch.kernels import rwkv6_scan_bwd as _rwkvb


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout q:(B,S,Hq,Dh), k/v:(B,S,Hkv,Dh) -> (B,S,Hq,Dh),
    contiguous: the kernel writes it in place through the transposed view,
    so the output projection flattens the heads without a copy.  K1, and
    K1b in the backward (``flash_attention_bwd.FlashAttention``)."""
    return _fab.FlashAttention.apply(q, k, v, causal, window)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """Model layout r/k/v/w:(B,S,H,Dh), u:(H,Dh), state:(B,H,Dh,Dh).
    Returns (out (B,S,H,Dh), new_state float32).  K2, and K2b in the
    backward (``rwkv6_scan_bwd.RWKV6Scan``: no gradient for either
    state)."""
    return _rwkvb.RWKV6Scan.apply(r, k, v, w, u, state)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x (..., D), scale (D,) -> x's shape and dtype (K3, and K3b in the
    backward: ``rmsnorm_bwd.RMSNorm``)."""
    return _rmsb.RMSNorm.apply(x, scale, eps)


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

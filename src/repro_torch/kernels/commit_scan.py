"""Binding of the hand-written Hopper greedy-commit kernel (K5).

``csrc/commit_scan.cu`` replaces the JAX kernel ``_build_commit_kernel``
of ``repro.core.batch_solver`` (a ``lax.scan`` in float64); its header
says how.  This module checks the arguments, allocates the results (the
final ``(free, gamma)`` carry among them), launches the kernel on
PyTorch's current stream and counts the launches in ``LAUNCHES``.  The
arguments and results are those of ``ref.commit_scan_ref``, its plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.find_alloc import (SMEM_EXCEEDED, check_args,
                                            check_wmax)

LAUNCHES = 0  # one per kernel launch, and nowhere else

_fn = None


def bind(lib: ctypes.CDLL):
    """The C entry ``commit_scan_fwd`` of a built library, typed."""
    fn = lib.commit_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 7
                   + [ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(build.load("commit_scan"))
    return _fn


def commit_scan(free, gamma, P_tab, node_row, W, Kj, single, rank, u_tab,
                s_m, s_u, s_rank, s_price, s_node, n_nodes: int,
                comm_frac: float, wmax: int):
    """The greedy commit of B jobs in order on the card, in one block;
    see ``ref.commit_scan_ref`` for the arguments and the results.
    ``wmax`` (at most ``find_alloc.MAX_W``) must be at least the largest
    gang in ``W``.  The tables are those ``core.batch_solver.scan_tables``
    builds: each job's pool is its whole (key, unit) table, with
    ``s_rank = rank[s_m]`` and ``s_node = node_row[s_m]``, since the
    kernel counts a prefix's eligible units from the carry before it
    walks the pool (``csrc/commit_scan.cu``)."""
    B, M = rank.shape
    R = u_tab.shape[1]
    L = s_m.shape[1]
    C = P_tab.shape[1]
    f64, i32, b8 = torch.float64, torch.int32, torch.bool
    check_args("commit_scan", {
        "free": (free, f64, (M,)), "gamma": (gamma, i32, (M,)),
        "P_tab": (P_tab, f64, (M, C)), "node_row": (node_row, i32, (M,)),
        "W": (W, f64, (B,)), "Kj": (Kj, i32, (B,)),
        "single": (single, b8, (B,)), "rank": (rank, i32, (B, M)),
        "u_tab": (u_tab, f64, (B, R)), "s_m": (s_m, i32, (B, L)),
        "s_u": (s_u, i32, (B, L)), "s_rank": (s_rank, i32, (B, L)),
        "s_price": (s_price, f64, (B, L)), "s_node": (s_node, i32, (B, L))})
    check_wmax("commit_scan", W, wmax)
    if min(B, M, n_nodes, R, C) < 1:
        raise ValueError("commit_scan: empty shapes")
    dev = rank.device
    out = (torch.empty_like(free), torch.empty_like(gamma),
           torch.empty(B, dtype=b8, device=dev),
           torch.empty(B, dtype=i32, device=dev),
           torch.empty((B, M), dtype=i32, device=dev),
           torch.empty(B, dtype=i32, device=dev),
           torch.empty(B, dtype=f64, device=dev),
           torch.empty((B, R), dtype=i32, device=dev))
    launch((free, gamma, P_tab, node_row, W, Kj, single, rank, u_tab, s_m,
            s_u, s_rank, s_price, s_node), out, n_nodes, comm_frac, wmax)
    return out


def launch(ins, out, n_nodes: int, comm_frac: float, wmax: int):
    """Launch K5 on the checked inputs ``ins`` into the allocated results
    ``out`` (both in ``commit_scan``'s order) on the current stream: no
    checks, no allocation, no synchronisation.  The inputs are not
    written, so a launch can be repeated."""
    global LAUNCHES
    B, M = ins[7].shape
    R, L, C = ins[8].shape[1], ins[9].shape[1], ins[2].shape[1]
    with torch.cuda.device(ins[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(*(t.data_ptr() for t in (*ins, *out)), B, M,
                        n_nodes, R, C, L, wmax, comm_frac, stream)
    if err == SMEM_EXCEEDED:
        raise ValueError(f"commit_scan: M={M}, N={n_nodes}, R={R}, "
                         f"wmax={wmax} need more shared memory than a "
                         f"block has")
    if err != 0:
        raise RuntimeError(f"commit_scan kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1

"""Binding of the hand-written Hopper FIND_ALLOC kernel (K4).

``csrc/find_alloc.cu`` replaces the JAX kernel ``_build_kernel`` of
``repro.core.batch_solver`` (a ``jit``-ed ``vmap`` in float64); its
header says how.  This module checks the arguments, allocates the
outputs, launches the kernel on PyTorch's current stream and counts the
launches in ``LAUNCHES``.  The arguments and results are those of
``ref.find_alloc_ref``, its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0  # one per kernel launch, and nowhere else

# the largest chosen spread set the kernel keeps per prefix (NumPy's
# pairwise-summation block: a longer sum would change its order)
MAX_W = 128
# what the C entries return when the runtime shapes need more shared
# memory than one block can have (227 KB on Hopper)
SMEM_EXCEEDED = -1
_fn = None


def bind(lib: ctypes.CDLL):
    """The C entry ``find_alloc_fwd`` of a built library, typed."""
    fn = lib.find_alloc_fwd
    fn.argtypes = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 7
                   + [ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(build.load("find_alloc"))
    return _fn


def check_args(kernel: str, spec: dict):
    """``spec``: name -> (tensor, dtype, shape).  Raises ValueError on a
    wrong dtype, shape or layout, or a tensor that is not on the card."""
    dev = None
    for name, (t, dtype, shape) in spec.items():
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} must be {dtype}, got "
                             f"{t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} must have shape "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if not t.is_cuda:
            raise ValueError(f"{kernel} kernel takes CUDA tensors only")
        if dev is not None and t.device != dev:
            raise ValueError(f"{kernel}: the arguments lie on different "
                             f"devices")
        dev = t.device


def check_wmax(kernel: str, W: torch.Tensor, wmax: int):
    """The kernels keep at most ``wmax`` chosen units per spread prefix:
    raise rather than truncate a larger gang (one read of max W)."""
    if not 1 <= wmax <= MAX_W:
        raise ValueError(f"{kernel}: wmax {wmax} outside 1..{MAX_W}")
    if W.numel() and float(W.max()) > wmax:
        raise ValueError(f"{kernel}: a gang of {float(W.max())} exceeds "
                         f"wmax {wmax}")


def find_alloc(avail, cumP, node_row, W, Kj, single, rank, u_tab, s_rank,
               s_valid, s_price, s_key, n_nodes: int, comm_frac: float,
               wmax: int):
    """FIND_ALLOC of B jobs against one shared state on the card; see
    ``ref.find_alloc_ref`` for the arguments and the results.  ``wmax``
    (at most ``MAX_W``) must be at least the largest gang in ``W``."""
    B, M = rank.shape
    R = u_tab.shape[1]
    L = s_rank.shape[1]
    C1 = cumP.shape[1]
    f64, i32, b8 = torch.float64, torch.int32, torch.bool
    check_args("find_alloc", {
        "avail": (avail, f64, (M,)), "cumP": (cumP, f64, (M, C1)),
        "node_row": (node_row, i32, (M,)), "W": (W, f64, (B,)),
        "Kj": (Kj, i32, (B,)), "single": (single, b8, (B,)),
        "rank": (rank, i32, (B, M)), "u_tab": (u_tab, f64, (B, R)),
        "s_rank": (s_rank, i32, (B, L)), "s_valid": (s_valid, b8, (B, L)),
        "s_price": (s_price, f64, (B, L)), "s_key": (s_key, i32, (B, L))})
    check_wmax("find_alloc", W, wmax)
    if min(B, M, n_nodes, R, C1) < 1:
        raise ValueError("find_alloc: empty shapes")
    dev = rank.device
    out = (torch.empty((B, n_nodes), dtype=b8, device=dev),
           torch.empty((B, n_nodes), dtype=i32, device=dev),
           torch.empty((B, n_nodes), dtype=i32, device=dev),
           torch.empty((B, n_nodes, R), dtype=f64, device=dev),
           torch.empty((B, n_nodes), dtype=f64, device=dev),
           torch.empty((B, n_nodes), dtype=f64, device=dev),
           torch.empty((B, R), dtype=b8, device=dev),
           torch.empty((B, R), dtype=f64, device=dev),
           torch.empty((B, R), dtype=i32, device=dev),
           torch.empty((B, R), dtype=i32, device=dev),
           torch.empty((B, R, M), dtype=i32, device=dev))
    launch((avail, cumP, node_row, W, Kj, single, rank, u_tab, s_rank,
            s_valid, s_price, s_key), out, n_nodes, comm_frac, wmax)
    return out


def launch(ins, out, n_nodes: int, comm_frac: float, wmax: int):
    """Launch K4 on the checked inputs ``ins`` into the allocated results
    ``out`` (both in ``find_alloc``'s order) on the current stream: no
    checks, no allocation, no synchronisation."""
    global LAUNCHES
    B, M = ins[6].shape
    R, L, C1 = ins[7].shape[1], ins[8].shape[1], ins[1].shape[1]
    with torch.cuda.device(ins[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(*(t.data_ptr() for t in (*ins, *out)), B, M,
                        n_nodes, R, C1, L, wmax, comm_frac, stream)
    if err == SMEM_EXCEEDED:
        raise ValueError(f"find_alloc: N={n_nodes}, R={R}, M={M}, "
                         f"wmax={wmax} need more shared memory than a block "
                         f"has")
    if err != 0:
        raise RuntimeError(f"find_alloc kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1

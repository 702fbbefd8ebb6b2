"""Binding of the hand-written Hopper WKV6 kernel.

``csrc/rwkv6_scan.cu`` replaces the TPU kernel of
``repro.kernels.rwkv6_scan``; its header says how.  This module checks the
arguments, allocates the output and the new state, launches the kernel on
PyTorch's current stream and counts the launches in ``LAUNCHES``.

Admitted dtypes, as the rwkv6 model calls it: r, k and v float32 or
bfloat16 (all three alike); w float32 or the dtype of r (the model's decay
is float32); u float32 or bfloat16; the state float32.  The kernel does all
its math in float32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0  # one per kernel launch, and nowhere else

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_fn = None


def bind(lib: ctypes.CDLL):
    """The C entry ``rwkv6_scan_fwd`` of a built library, typed."""
    fn = lib.rwkv6_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 16 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(build.load("rwkv6_scan"))
    return _fn


def _check(r, k, v, w, u, state):
    x = r.dtype
    if x not in _DTYPES or k.dtype != x or v.dtype != x:
        raise ValueError(f"r, k, v must be all float32 or all bfloat16, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype not in (torch.float32, x):
        raise ValueError(f"w must be float32 or {x}, got {w.dtype}")
    if u.dtype not in _DTYPES:
        raise ValueError(f"u must be float32 or bfloat16, got {u.dtype}")
    if state.dtype != torch.float32:
        raise ValueError(f"the state must be float32, got {state.dtype}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"want r, k, v, w all (B,H,S,D), got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, H, S, D = r.shape
    if tuple(u.shape) != (H, D) or tuple(state.shape) != (B, H, D, D):
        raise ValueError(f"want u ({H},{D}) and state ({B},{H},{D},{D}), got "
                         f"{tuple(u.shape)}, {tuple(state.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if S < 1:
        raise ValueError("empty sequence")
    if any(t.stride(-1) != 1 for t in (r, k, v, w, u)):
        raise ValueError("the head dim of r, k, v, w and u must be "
                         "contiguous")
    if not state.is_contiguous():
        raise ValueError("the state must be contiguous")
    ts = (r, k, v, w, u, state)
    if not all(t.is_cuda for t in ts):
        raise ValueError("rwkv6_scan kernel takes CUDA tensors only")
    if any(t.device != r.device for t in ts):
        raise ValueError("r, k, v, w, u and the state lie on different "
                         "devices")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """Kernel layout r,k,v,w: (B,H,S,D); u: (H,D); state: (B,H,D,D)
    float32 -> (out (B,H,S,D) in r's dtype, new state (B,H,D,D) float32)
    on the card.  Any S >= 1; strided inputs are read in place as long as
    D is contiguous."""
    global LAUNCHES
    _check(r, k, v, w, u, state)
    B, H, S, D = r.shape
    out = torch.empty((B, H, S, D), dtype=r.dtype, device=r.device)
    new_state = torch.empty((B, H, D, D), dtype=torch.float32,
                            device=r.device)
    strides = [s for t in (r, k, v, w, out) for s in t.stride()[:3]]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        w.data_ptr(), u.data_ptr(), state.data_ptr(),
                        out.data_ptr(), new_state.data_ptr(), _DTYPES[r.dtype],
                        _DTYPES[w.dtype], _DTYPES[u.dtype], B, H, S, D,
                        *strides, u.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out, new_state

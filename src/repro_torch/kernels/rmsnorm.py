"""Binding of the hand-written Hopper RMSNorm kernel (K3).

``csrc/rmsnorm.cu`` replaces the TPU kernel of ``repro.kernels.rmsnorm``;
its header says how.  This module checks the arguments, allocates the
output, launches the kernel on PyTorch's current stream and counts the
launches in ``LAUNCHES``.

Admitted dtypes: x float32 or bfloat16; scale float32 or x's dtype.  The
kernel does all its math in float32 and writes x's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0  # one per kernel launch, and nowhere else

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def bind(lib: ctypes.CDLL):
    """The C entry ``rmsnorm_fwd`` of a built library, typed."""
    fn = lib.rmsnorm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(build.load("rmsnorm"))
    return _fn


def _rows(x: torch.Tensor):
    """(number of rows, row stride) of x seen as rows of its last dim,
    without a copy; raises if the leading dims do not collapse to one
    stride."""
    D = x.shape[-1]
    if x.dim() == 1:
        return 1, D
    try:
        x2 = x.view(-1, D)
    except RuntimeError:
        raise ValueError(f"x of shape {tuple(x.shape)} and strides "
                         f"{x.stride()} is not a strided set of rows")
    return x2.shape[0], x2.stride(0)


def _check(x: torch.Tensor, scale: torch.Tensor):
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if scale.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"scale must be float32 or {x.dtype}, got "
                         f"{scale.dtype}")
    if x.dim() < 1 or scale.dim() != 1 or scale.shape[0] != x.shape[-1]:
        raise ValueError(f"want x (..., D) and scale (D,), got "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}")
    if x.shape[-1] < 1:
        raise ValueError("empty rows")
    if x.stride(-1) != 1 or scale.stride(0) != 1:
        raise ValueError("the last dim of x and scale must be contiguous")
    if not (x.is_cuda and scale.is_cuda):
        raise ValueError("rmsnorm kernel takes CUDA tensors only")
    if x.device != scale.device:
        raise ValueError("x and scale lie on different devices")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x (..., D) -> x * rsqrt(mean(x^2) + eps) * scale, contiguous, in
    x's dtype, on the card.  Any number of rows, no padding; a strided
    set of rows (last dim contiguous) is read in place."""
    global LAUNCHES
    _check(x, scale)
    rows, stride = _rows(x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        _DTYPES[x.dtype], _DTYPES[scale.dtype], rows,
                        x.shape[-1], stride, eps, stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out

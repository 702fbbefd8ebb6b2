"""Binding of the hand-written Hopper flash-attention kernel.

``csrc/flash_attention.cu`` replaces the TPU kernel of
``repro.kernels.flash_attention``; its header says how.  This module checks
the arguments, allocates the output, launches the kernel on PyTorch's
current stream and counts the launches in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0  # one per kernel launch, and nowhere else

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_fn = None


def bind(lib: ctypes.CDLL):
    """The C entry ``flash_attention_fwd`` of a built library, typed."""
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(build.load("flash_attention"))
    return _fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel takes CUDA tensors only")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes {q.dtype}, {k.dtype}, {v.dtype}:"
                         f" the kernel takes float32 or bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Hq,S,D) and k, v (B,Hkv,S,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, S, D = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[1]}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 4 or any(st % 2 for st in t.stride()[:-1])
            for t in (q, k, v)):
        raise ValueError("bfloat16 q, k and v need even strides and 4-byte "
                         "aligned data: the kernel moves bf16 pairs")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Kernel layout q: (B,Hq,S,D); k,v: (B,Hkv,S,D) -> (B,Hq,S,D) on the
    card.  Any S; strided inputs are read in place as long as D is
    contiguous."""
    global LAUNCHES
    _check(q, k, v)
    B, Hq, S, D = q.shape
    out = torch.empty((B, Hq, S, D), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), _DTYPES[q.dtype], B, Hq, k.shape[1],
                        S, D, *strides, int(causal), int(window),
                        1.0 / D ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out

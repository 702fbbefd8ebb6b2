"""Binding of the hand-written Hopper flash-attention kernel.

``csrc/flash_attention.cu`` replaces the TPU kernel of
``repro.kernels.flash_attention``; its header says how.  This module checks
the arguments (for bfloat16 the layout TMA needs, ``tma_layout_error``),
allocates the output unless the caller gives one, launches the kernel on
PyTorch's current stream and counts the launches in ``LAUNCHES``.
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


def tma_layout_error(shape, strides, itemsize: int, ptr: int):
    """Why TMA cannot read or write a tensor of this layout, or None.

    The bf16 kernel moves every tile by TMA: the last dim contiguous, the
    data pointer 16-byte aligned and every other stride a multiple of 16
    bytes.  A dim of extent 1 is never stepped, so its stride is free."""
    if strides[-1] != 1:
        return "the head dim is not contiguous"
    if ptr % 16:
        return f"data pointer {ptr:#x} is not 16-byte aligned"
    bad = [st for n, st in zip(shape[:-1], strides[:-1])
           if n > 1 and (st * itemsize) % 16]
    if bad:
        return (f"strides {bad} (elements of {itemsize} bytes) are not "
                f"multiples of 16 bytes")
    return None


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor):
    if not (q.is_cuda and k.is_cuda and v.is_cuda and out.is_cuda):
        raise ValueError("flash_attention kernel takes CUDA tensors only")
    if not (q.device == k.device == v.device == out.device):
        raise ValueError("q, k, v and out lie on different devices")
    if (q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype
            or out.dtype != q.dtype):
        raise ValueError(f"unsupported dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}, {out.dtype}: the kernel takes float32 "
                         f"or bfloat16, the same for all four")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Hq,S,D) and k, v (B,Hkv,S,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, S, D = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if out.shape != q.shape:
        raise ValueError(f"out shape {tuple(out.shape)} is not q's "
                         f"{tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[1]}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if q.dtype == torch.float32:  # the f32 kernel reads any D-row
            err = t.stride(-1) != 1 and "the head dim is not contiguous"
        else:
            err = tma_layout_error(t.shape, t.stride(), t.element_size(),
                                   t.data_ptr())
        if err:
            raise ValueError(f"{name}: {err}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    out: torch.Tensor = None) -> torch.Tensor:
    """Kernel layout q: (B,Hq,S,D); k,v: (B,Hkv,S,D) -> (B,Hq,S,D) on the
    card.  Any S; strided inputs are read in place.  ``out``, if given, is
    written in place and returned: a (B,Hq,S,D) view of any layout the
    inputs may have, for example a transposed (B,S,Hq,D) tensor."""
    global LAUNCHES
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _check(q, k, v, out)
    B, Hq, S, D = q.shape
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

"""Binding of the hand-written Hopper flash-attention backward (K1b), and
the autograd ``Function`` of K1 that ``ops.flash_attention`` calls.

``csrc/flash_attention_bwd.cu`` computes the gradient that the JAX package
takes by autodiff through its plain attention; its header says how.  Its
form follows the dtype (``FORMS``): bfloat16 runs on the tensor cores
(TMA and wgmma), float32 on the CUDA cores.  ``flash_attention_bwd``
checks the arguments, takes the bfloat16 form's split of pass 1 from
``plan``, allocates dq, dk, dv and the float32 scratch (each row's
softmax statistics and delta = sum_j P_ij dP_ij; the split's partial dK
and dV), launches the kernel's passes on PyTorch's current stream and
counts one launch in ``LAUNCHES``.  q, k, v and dO are read in place
through their strides (the head dim contiguous, and for bfloat16 the
layout TMA needs, ``flash_attention.tma_layout_error``; a dO that is not
is copied to contiguous first); the forward's output is not read.  dq, dk
and dv are written in q, k and v's model layout, (B, S, H, D) contiguous,
and returned as (B, H, S, D) views of it.

``FlashAttention`` dispatches on the device: on a CUDA tensor its forward
launches K1 and its backward K1b; on the CPU its forward is the plain
version (``ref.flash_attention_ref``) and its backward that version's
autograd, recomputed.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as _fwd

LAUNCHES = 0  # one per kernel launch, and nowhere else

# the kernel's form for each dtype (the C entry dispatches on it)
FORMS = {torch.bfloat16: "wgmma", torch.float32: "f32"}
# the bfloat16 form: keys of a pass-1 block, and the row statistics' rows
# (S rounded up to it); an H100 SXM's SMs
KEY_TILE = 128
SMS = 132

_fn = None


@dataclass(frozen=True)
class Plan:
    """How a call runs: the form, the number of groups each kv head's G
    query heads are split into for pass 1 (``split_heads``), and the rows
    of the statistics' scratch."""
    form: str
    splits: int
    rows: int


def plan(B: int, Hq: int, Hkv: int, S: int, D: int, dtype) -> Plan:
    """The bfloat16 form splits pass 1 when its grid (key tiles x Hkv x B
    blocks) is below the SM count: toward two blocks an SM, n = min(G,
    ceil(2 SMS / blocks)) groups of ceil(G / n) heads each (the last may
    be shorter; none is empty, so there may be fewer than n).  The float32
    form is never split.  A function of the shape alone."""
    if FORMS[dtype] == "f32":
        return Plan("f32", 1, S)
    rows = -(-S // KEY_TILE) * KEY_TILE
    G = Hq // Hkv
    blocks = rows // KEY_TILE * Hkv * B
    splits = 1
    if blocks < SMS:
        want = min(G, -(-2 * SMS // blocks))
        splits = -(-G // -(-G // want))   # no empty group
    return Plan("wgmma", splits, rows)


def split_heads(G: int, splits: int) -> list:
    """The query heads (0 .. G-1 within a kv head) of each split, as the
    kernel takes them: contiguous groups of ceil(G / splits)."""
    chunk = -(-G // splits)
    return [range(z * chunk, min(G, (z + 1) * chunk)) for z in range(splits)]


def bind(lib: ctypes.CDLL):
    """The C entry ``flash_attention_bwd`` of a built library, typed."""
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 21
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(build.load("flash_attention_bwd"))
    return _fn


def _check(q, k, v, do):
    ts = (q, k, v, do)
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash_attention_bwd kernel takes CUDA tensors only")
    if any(t.device != q.device for t in ts):
        raise ValueError("q, k, v and dO lie on different devices")
    if q.dtype not in _fwd._DTYPES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"unsupported dtypes {[t.dtype for t in ts]}: the "
                         f"kernel takes float32 or bfloat16, the same for "
                         f"all four")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Hq,S,D) and k, v (B,Hkv,S,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, S, D = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[1]}")
    if D not in _fwd._HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_fwd._HEAD_DIMS}")
    if S < 1:
        raise ValueError("empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if q.dtype == torch.float32:
            err = t.stride(-1) != 1 and "the head dim is not contiguous"
        else:
            err = _fwd.tma_layout_error(t.shape, t.stride(), t.element_size(),
                                        t.data_ptr())
        if err:
            raise ValueError(f"{name}: {err}")


def _readable(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` in place (else it is copied)."""
    if t.dtype == torch.float32:
        return t.stride(-1) == 1
    return _fwd.tma_layout_error(t.shape, t.stride(), t.element_size(),
                                 t.data_ptr()) is None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, causal: bool = True,
                        window: int = 0):
    """Kernel layout q, dO: (B,Hq,S,D); k, v: (B,Hkv,S,D) -> (dq, dk, dv)
    of K1's attention with the same masks, in q's dtype, on the card."""
    global LAUNCHES
    _check(q, k, v, do)
    if not _readable(do):
        do = do.contiguous()
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    p = plan(B, Hq, Hkv, S, D, q.dtype)

    def grad_like(H):
        return torch.empty((B, S, H, D), dtype=q.dtype,
                           device=q.device).transpose(1, 2)

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.float32, device=q.device)

    dq, dk, dv = grad_like(Hq), grad_like(Hkv), grad_like(Hkv)
    # f32: lse (natural) and delta; wgmma: the row max (base 2) and 1 / l,
    # and delta as a pivot (a dP of the row) and delta - pivot
    rows = (B, Hq, S) if p.form == "f32" else (2, B, Hq, p.rows)
    lse, delta = scratch(*rows), scratch(*rows)
    part = (scratch(2, p.splits, B, Hkv, p.rows, D) if p.splits > 1
            else None)
    strides = [s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        None if part is None else part.data_ptr(),
                        _fwd._DTYPES[q.dtype], B, Hq, Hkv, S, D, p.splits,
                        *strides, int(causal), int(window), 1.0 / D ** 0.5,
                        stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, causal, window)`` in model layout:
    q (B,S,Hq,D), k and v (B,S,Hkv,D) -> (B,S,Hq,D) contiguous (the
    kernel writes it in place through the transposed view).  K1 forward
    and K1b backward on the card; the plain version and its autograd on
    the CPU.  Gradients for q, k and v in their dtype, model layout; none
    for causal and window."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        if q.device.type == "cpu":
            out.transpose(1, 2).copy_(
                ref.flash_attention_ref(qt, kt, vt, causal, window))
        else:
            _fwd.flash_attention(qt, kt, vt, causal=causal, window=window,
                                 out=out.transpose(1, 2))
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        if q.device.type == "cpu":
            with torch.enable_grad():
                ins = [t.detach().requires_grad_() for t in (q, k, v)]
                o = ref.flash_attention_ref(*(t.transpose(1, 2) for t in ins),
                                            ctx.causal, ctx.window)
                grads = torch.autograd.grad(o, ins, dout.transpose(1, 2))
            return (*grads, None, None)
        dq, dk, dv = flash_attention_bwd(
            *(t.transpose(1, 2) for t in (q, k, v, dout)),
            causal=ctx.causal, window=ctx.window)
        return (*(t.transpose(1, 2) for t in (dq, dk, dv)), None, None)

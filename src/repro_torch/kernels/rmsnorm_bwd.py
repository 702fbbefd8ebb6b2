"""Binding of the hand-written Hopper RMSNorm backward (K3b), and the
autograd ``Function`` of K3 that ``ops.rmsnorm`` calls.

``csrc/rmsnorm_bwd.cu`` computes the gradient that the JAX package takes
by autodiff through its plain norm; its header says how.  ``rmsnorm_bwd``
checks the arguments, picks the kernel's form and its rows a block
(``plan``), allocates the outputs and the (blocks, D) float32 scratch of
dscale's per-block partials, launches the kernel on PyTorch's current
stream and counts the launches in ``LAUNCHES``.  x and dy are read in
place where each is one strided set of rows (last dim contiguous); a dy
of any other layout is copied to contiguous first.

``RMSNorm`` dispatches on the device: on a CUDA tensor its forward
launches K3 and its backward K3b; on the CPU its forward is the plain
version (``ref.rmsnorm_ref``) and its backward that version's autograd,
recomputed.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import rmsnorm as _fwd

LAUNCHES = 0  # one per kernel launch, and nowhere else

THREADS = 256  # threads a block of either form
_fn = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """How K3b runs one call: its form ("regs", the register form, or
    "general"), the rows each block walks and the number of blocks (the
    rows of dscale's partial buffer)."""
    form: str
    rows_per_block: int
    blocks: int


def plan(rows: int, D: int, dtype: torch.dtype, scale_dtype: torch.dtype,
         aligned: bool = True, sms: int = 132) -> Plan:
    """K3b's form and rows a block, a pure function of the shape, the
    dtypes, whether x's and dy's rows (and the scale) are 16-byte aligned,
    and the SM count.  The register form takes rows of exactly 1, 2 or 4
    16-byte vectors a thread with a scale of x's dtype; its blocks hold
    1-4 vectors of x and of dy a thread in flight, so 4, 2 or 1 blocks an
    SM fill the card in one wave (one such block a thread's registers
    allow).  The general form keeps two blocks an SM.  Each block walks a
    contiguous run of rows, as many as spread the rows over those
    blocks."""
    item = torch.empty((), dtype=dtype).element_size()
    row_bytes = D * item
    vpt = row_bytes // (16 * THREADS) if row_bytes % (16 * THREADS) == 0 \
        else 0
    regs = aligned and scale_dtype == dtype and vpt in (1, 2, 4)
    per_sm = 4 // vpt if regs else 2
    rpb = max(1, -(-rows // max(1, min(rows, per_sm * sms))))
    return Plan("regs" if regs else "general", rpb, -(-rows // rpb))


def _aligned(t: torch.Tensor, stride: int) -> bool:
    return (t.data_ptr() % 16 == 0
            and stride * t.element_size() % 16 == 0)


def bind(lib: ctypes.CDLL):
    """The C entry ``rmsnorm_bwd`` of a built library, typed."""
    fn = lib.rmsnorm_bwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(build.load("rmsnorm_bwd"))
    return _fn


def _rows_of(t: torch.Tensor):
    """(t, rows, row stride), with t copied to contiguous where it is not
    one strided set of rows."""
    try:
        rows, stride = _fwd._rows(t)
    except ValueError:
        t = t.contiguous()
        rows, stride = _fwd._rows(t)
    return t, rows, stride


def _launch(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor):
    """(dy as the kernel reads it, rows, x's and dy's row strides, the
    plan) of a call on CUDA tensors."""
    rows, x_stride = _fwd._rows(x)
    dy, _, dy_stride = _rows_of(dy)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    aligned = (_aligned(x, x_stride) and _aligned(dy, dy_stride)
               and scale.data_ptr() % 16 == 0)
    return (dy, rows, x_stride, dy_stride,
            plan(rows, x.shape[-1], x.dtype, scale.dtype, aligned, sms))


def plan_of(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor) -> Plan:
    """The plan ``rmsnorm_bwd`` launches for these CUDA tensors."""
    return _launch(x, scale, dy)[-1]


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5):
    """(dx in x's dtype and shape, contiguous; dscale in scale's dtype) of
    ``x * rsqrt(mean(x^2) + eps) * scale`` on the card.  dy has x's shape
    and dtype."""
    global LAUNCHES
    _fwd._check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if not dy.is_cuda or dy.device != x.device:
        raise ValueError("dy must lie on x's CUDA device")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    dy, rows, x_stride, dy_stride, p = _launch(x, scale, dy)
    D = x.shape[-1]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dscale = torch.empty((D,), dtype=scale.dtype, device=x.device)
    if rows == 0:
        return dx, dscale.zero_()
    partial = torch.empty((p.blocks, D), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                        dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(),
                        _fwd._DTYPES[x.dtype], _fwd._DTYPES[scale.dtype],
                        rows, D, p.rows_per_block, p.blocks, x_stride,
                        dy_stride, eps, int(p.form == "regs"), stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return dx, dscale


class RMSNorm(torch.autograd.Function):
    """``RMSNorm.apply(x, scale, eps)``: K3 forward, K3b backward on the
    card; the plain version and its autograd on the CPU.  Gradients for x
    and scale in their dtypes; none for eps."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        if x.device.type == "cpu":
            return ref.rmsnorm_ref(x, scale, eps)
        return _fwd.rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        if x.device.type == "cpu":
            with torch.enable_grad():
                xd, sd = x.detach().requires_grad_(), scale.detach().requires_grad_()
                dx, ds = torch.autograd.grad(ref.rmsnorm_ref(xd, sd, ctx.eps),
                                             (xd, sd), dy)
            return dx, ds, None
        dx, ds = rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, ds, None

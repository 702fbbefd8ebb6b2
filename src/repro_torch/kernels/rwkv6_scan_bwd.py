"""Binding of the hand-written Hopper WKV6 backward (K2b), and the
autograd ``Function`` of K2 that ``ops.rwkv6_scan`` calls.

``csrc/rwkv6_scan_bwd.cu`` computes the gradient that the JAX package
takes by autodiff through its plain scan; its header says how.
``rwkv6_scan_bwd`` checks the arguments, plans the launch (``plan``),
allocates dr, dk, dv, dw and du and the kernel's float32 scratch (the
state checkpoints every 16 steps, du's per-(batch, head) sums), launches
the kernel on PyTorch's current stream and counts the launches in
``LAUNCHES``.  The inputs are read in place through their strides (head
dim contiguous, rows 16-byte aligned; an input of another layout is
copied to contiguous first); w and u are handed to the kernel in float32
(a copy only where they are not), and dw and du come back in their
dtypes.

``RWKV6Scan`` dispatches on the device: on a CUDA tensor its forward
launches K2 and its backward K2b; on the CPU its forward is the plain
version (``ref.rwkv6_scan_ref``) and its backward that version's autograd,
recomputed.  Its backward gives no gradient for the initial state and
takes none for the new state: ``apply`` raises if the state requires
grad, and the backward raises if the new state's gradient is asked for
(the model passes a zero state and drops the new one).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import rwkv6_scan as _fwd

LAUNCHES = 0  # one per kernel launch, and nowhere else

CHUNK = 16  # steps between the kernel's state checkpoints, and a chunk
KEYS = 16  # keys a block
_fn = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """How K2b runs one call: its form, the keys a block owns (with all
    value columns), the blocks of one (batch, head) (a thread-block
    cluster), the threads a block, the steps a chunk and the checkpoints
    a (batch, head)."""
    form: str
    keys: int
    cluster: int
    threads: int
    chunk: int
    checkpoints: int


def plan(B: int, H: int, S: int, D: int) -> Plan:
    """K2b's launch, a pure function of the shape: the "cluster" form, a
    block per 16 keys of a (batch, head), the D / 16 blocks of a (batch,
    head) in one cluster (at most 8, the portable cluster size, at
    D = 128), a thread per 2 keys and 4 columns (2 D threads), chunks of
    16 steps and a checkpoint before each."""
    if D not in _fwd._HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {_fwd._HEAD_DIMS}")
    return Plan("cluster", KEYS, D // KEYS, 2 * D, CHUNK, -(-S // CHUNK))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy of it where its rows (last dim) do not
    start on 16-byte boundaries."""
    e = t.element_size()
    if t.data_ptr() % 16 == 0 and all(s * e % 16 == 0
                                      for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def bind(lib: ctypes.CDLL):
    """The C entry ``rwkv6_scan_bwd`` of a built library, typed."""
    fn = lib.rwkv6_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 27 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(build.load("rwkv6_scan_bwd"))
    return _fn


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                   d_out: torch.Tensor):
    """Kernel layout r, k, v, w, d_out: (B,H,S,D); u: (H,D); state:
    (B,H,D,D) float32, the scan's initial state -> (dr, dk, dv, dw, du)
    of the scan's output (not its new state) on the card: dr, dk, dv in
    r's dtype and (B,H,S,D) views of (B,S,H,D) tensors, dw in w's dtype
    likewise, du (H,D) in u's dtype."""
    global LAUNCHES
    _fwd._check(r, k, v, w, u, state)
    if d_out.shape != r.shape or d_out.dtype != r.dtype:
        raise ValueError(f"d_out {tuple(d_out.shape)} {d_out.dtype} does not "
                         f"match r {tuple(r.shape)} {r.dtype}")
    if not d_out.is_cuda or d_out.device != r.device:
        raise ValueError("d_out must lie on r's CUDA device")
    if d_out.stride(-1) != 1:
        d_out = d_out.contiguous()
    B, H, S, D = r.shape
    p = plan(B, H, S, D)
    dev = r.device
    wf = w.float() if w.dtype != torch.float32 else w
    r, k, v, wf, d_out = (_aligned(t) for t in (r, k, v, wf, d_out))
    if state.data_ptr() % 16:
        state = state.clone()
    uf = u.float().contiguous()

    def grad_like(dtype):
        return torch.empty((B, S, H, D), dtype=dtype,
                           device=dev).transpose(1, 2)

    dr, dk, dv = (grad_like(r.dtype) for _ in range(3))
    dw = grad_like(torch.float32)
    du = torch.empty((H, D), dtype=torch.float32, device=dev)
    du_part = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    ckpt = torch.empty((B, H, p.checkpoints, D, D), dtype=torch.float32,
                       device=dev)
    strides = [s for t in (r, k, v, wf, d_out, dr, dk, dv, dw)
               for s in t.stride()[:3]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        wf.data_ptr(), d_out.data_ptr(), uf.data_ptr(),
                        state.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(),
                        du.data_ptr(), ckpt.data_ptr(),
                        _fwd._DTYPES[r.dtype], B, H, S, D, p.cluster,
                        *strides, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_bwd kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return dr, dk, dv, dw.to(w.dtype), du.to(u.dtype)


class RWKV6Scan(torch.autograd.Function):
    """``RWKV6Scan.apply(r, k, v, w, u, state)`` in model layout: r, k, v,
    w (B,S,H,D), u (H,D), state (B,H,D,D) float32 -> (out (B,S,H,D) in
    r's dtype, new state float32).  K2 forward and K2b backward on the
    card; the plain version and its autograd on the CPU.  Gradients for r,
    k, v, w and u in their dtypes; none for the state, which must not
    require grad, and the new state's gradient must not be asked for."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        if state.requires_grad:
            raise ValueError("RWKV6Scan gives no gradient for the initial "
                             "state; pass one that does not require grad")
        ctx.set_materialize_grads(False)
        ts = [t.transpose(1, 2) for t in (r, k, v, w)]
        if r.device.type == "cpu":
            out, s = ref.rwkv6_scan_ref(*ts, u, state)
        else:
            out, s = _fwd.rwkv6_scan(*ts, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        return out.transpose(1, 2), s

    @staticmethod
    def backward(ctx, d_out, d_state):
        if d_state is not None:
            raise RuntimeError("RWKV6Scan takes no gradient of the new "
                               "state")
        r, k, v, w, u, state = ctx.saved_tensors
        if d_out is None:
            return None, None, None, None, None, None
        if r.device.type == "cpu":
            with torch.enable_grad():
                ins = [t.detach().requires_grad_() for t in (r, k, v, w, u)]
                out, _ = ref.rwkv6_scan_ref(
                    *(t.transpose(1, 2) for t in ins[:4]), ins[4], state)
                grads = torch.autograd.grad(out, ins, d_out.transpose(1, 2))
            return (*grads, None)
        dr, dk, dv, dw, du = rwkv6_scan_bwd(
            *(t.transpose(1, 2) for t in (r, k, v, w)), u, state,
            d_out.transpose(1, 2))
        return (*(t.transpose(1, 2) for t in (dr, dk, dv, dw)), du, None)

"""Public wrapper of the RG-LRU recurrence kernel (``csrc/rg_lru.cu``).

Counterpart of ``repro/kernels/rg_lru/ops.py:14 rg_lru_op``: the
recurrence runs in fp32 and the outputs come back in the input's dtype.
It also returns the last h in fp32, the Griffin block's recurrent state,
so the block needs no slice and copy of its own. CPU tensors go to the
plain version in ``ref.py``; CUDA tensors go to the kernel or raise; meta
tensors get empty outputs of the kernel's shapes and dtypes. Each entry
runs inside ``cost.kernel`` with 0 FLOPs (the reference's scan has no dot
product) and its bytes. The
kernel reads fp32 or bf16 a and b and writes h in their dtype, so either is
one launch; other dtypes are cast to fp32 around it, as the JAX op casts.
``LAUNCHES["rg_lru"]`` counts kernel launches and nothing else.

With grad mode on and a, b or h0 requiring grad, the op is
``RGLRUFunction`` (fp32 only): its forward is the same kernel, which saves
every h_t, and its backward the reverse scan of ``csrc/rg_lru_bwd.cu``
(``ref.rg_lru_bwd_ref`` on the CPU). ``LAUNCHES["rg_lru_bwd"]`` counts the
backward kernel's launches.
"""

from __future__ import annotations

import torch

from .. import _build, cost
from ..cost import contiguous
from .ref import rg_lru_bwd_ref, rg_lru_ref

LAUNCHES = {"rg_lru": 0, "rg_lru_bwd": 0}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/rg_lru.cu's codes


def _check(a, b, h0) -> None:
    if a.dim() != 3:
        raise ValueError(f"a must be 3-D (batch, seq, d), got {tuple(a.shape)}")
    if b.shape != a.shape:
        raise ValueError(f"b has shape {tuple(b.shape)}, expected {tuple(a.shape)} like a")
    if a.shape[1] == 0:
        raise ValueError("rg_lru_op needs at least one time step")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if h0 is not None:
        if tuple(h0.shape) != (a.shape[0], a.shape[2]):
            raise ValueError(f"h0 has shape {tuple(h0.shape)}, expected "
                             f"{(a.shape[0], a.shape[2])}")
        if h0.device != a.device:
            raise ValueError(f"h0 is on {h0.device}, a on {a.device}")


def rg_lru_op(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t·h_{t−1} + b_t over a, b ``(batch, seq, d)`` from h0
    ``(batch, d)`` (zero when None) -> (h ``(batch, seq, d)`` in a's dtype,
    the last h ``(batch, d)`` in fp32), fresh tensors. Differentiable
    (fp32) when grad mode is on and an input requires grad."""
    _check(a, b, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (a, b, h0)):
        if any(t is not None and t.dtype != torch.float32 for t in (a, b, h0)):
            raise TypeError(f"rg_lru_op: gradients are fp32 only, got {a.dtype} and {b.dtype}: "
                            "the reference computes the RG-LRU recurrence in fp32 "
                            "(repro/models/rglru.py:73-95), and the model gives it fp32 a "
                            "and b in every dtype (ROADMAP.md Queue 1 item 3)")
        return RGLRUFunction.apply(a, b, h0)
    return _forward(a, b, h0)


def _forward(a, b, h0):
    """``rg_lru_op`` without a gradient: the plain version on the CPU, the
    kernel on the card."""
    batch, _, d = a.shape
    with cost.kernel("rg_lru", 0, cost.nbytes(a, b, h0, a) + 4 * batch * d):
        return _forward_on(a, b, h0)


def _forward_on(a, b, h0):
    """``_forward`` by device."""
    if a.device.type == "meta":
        return (torch.empty(a.shape, dtype=a.dtype, device=a.device),
                torch.empty((a.shape[0], a.shape[2]), dtype=torch.float32, device=a.device))
    if a.device.type == "cpu":
        h, last = rg_lru_ref(a, b, h0)
        return contiguous((h.to(a.dtype), last))
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru_op: unsupported device {a.device}")
    batch, seq, d = a.shape
    if batch > 65535:
        raise ValueError(f"rg_lru_op: batch {batch} exceeds the grid")
    if a.dtype == b.dtype == torch.bfloat16:
        ac, bc = a.contiguous(), b.contiguous()
    else:
        ac, bc = a.float().contiguous(), b.float().contiguous()
    hf = None if h0 is None else h0.float().contiguous()
    out = torch.empty_like(ac)
    last = torch.empty((batch, d), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out.to(a.dtype), last
    err = _build.library().rg_lru(
        ac.data_ptr(), bc.data_ptr(), None if hf is None else hf.data_ptr(),
        out.data_ptr(), last.data_ptr(), _DTYPE[ac.dtype], batch, seq, d,
        _build.current_stream(a.device))
    _build.check(err, "rg_lru")
    LAUNCHES["rg_lru"] += 1
    return out.to(a.dtype), last


def rg_lru_bwd(a, h, h0, dh, dlast):
    """The backward of ``rg_lru_op``, fp32 -> (da, db ``(batch, seq, d)``,
    dh0 ``(batch, d)`` or None without h0): ``rg_lru_bwd.cu`` on the card,
    ``rg_lru_bwd_ref`` on the CPU. ``h`` is the forward's every h_t; ``dh``
    and ``dlast`` may be None (a zero gradient)."""
    batch, seq, d = a.shape
    for name, t, shape in (("a", a, (batch, seq, d)), ("h", h, (batch, seq, d)),
                           ("h0", h0, (batch, d)), ("dh", dh, (batch, seq, d)),
                           ("dlast", dlast, (batch, d))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"rg_lru_bwd: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected float32 {shape} on {a.device}")
    with cost.kernel("rg_lru_bwd", 0, cost.nbytes(a, h, h0, dh, dlast, a, a, h0)):
        return _bwd(a, h, h0, dh, dlast)


def _bwd(a, h, h0, dh, dlast):
    """``rg_lru_bwd`` by device."""
    batch, seq, d = a.shape
    if a.device.type == "meta":
        return (torch.empty(a.shape, dtype=a.dtype, device=a.device),
                torch.empty(a.shape, dtype=a.dtype, device=a.device),
                None if h0 is None else torch.empty(h0.shape, dtype=h0.dtype, device=h0.device))
    if a.device.type == "cpu":
        return contiguous(rg_lru_bwd_ref(a, h, h0, dh, dlast))
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru_bwd: unsupported device {a.device}")
    if batch > 65535:
        raise ValueError(f"rg_lru_bwd: batch {batch} exceeds the grid")
    a, h = a.contiguous(), h.contiguous()
    h0, dh, dlast = (None if t is None else t.contiguous() for t in (h0, dh, dlast))
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if a.numel() == 0:
        return da, db, None if dh0 is None else dh0.zero_()

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.library().rg_lru_bwd_f32(
        a.data_ptr(), h.data_ptr(), ptr(h0), ptr(dh), ptr(dlast), da.data_ptr(),
        db.data_ptr(), ptr(dh0), batch, seq, d, _build.current_stream(a.device))
    _build.check(err, "rg_lru_bwd")
    LAUNCHES["rg_lru_bwd"] += 1
    return da, db, dh0


class RGLRUFunction(torch.autograd.Function):
    """``rg_lru_op`` with a gradient, fp32: the forward saves a, every h_t
    and h0; the backward is the reverse scan. A ``None`` incoming gradient
    (of h or of the last h) is a zero one."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, last = _forward(a, b, h0)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, h, h0)
        return h, last

    @staticmethod
    def backward(ctx, dh, dlast):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = rg_lru_bwd(a, h, h0, dh, dlast)
        need = ctx.needs_input_grad
        return (da if need[0] else None, db if need[1] else None,
                dh0 if need[2] else None)

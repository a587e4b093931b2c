"""Public wrapper of the fused LSTM cell kernel (``csrc/lstm_cell.cu``).

Counterpart of ``repro/kernels/lstm_cell/ops.py:16 lstm_cell_op``. CPU
tensors go to the plain version in ``ref.py``; CUDA tensors go to the
hand-written kernel or raise. ``LAUNCHES["lstm_cell"]`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import lstm_cell_ref

LAUNCHES = {"lstm_cell": 0}

_ENTRY = {torch.float32: "lstm_cell_f32", torch.bfloat16: "lstm_cell_bf16"}
_FN: dict = {}  # dtype -> the library's entry point, resolved at its first launch
MAX_BATCH = 65535 * 64  # the kernel's grid holds 65,535 tiles of 64 batch rows


def _check(x, h, c, wx, wh, b) -> tuple[int, int, int]:
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError(f"x and h must be 2-D, got {tuple(x.shape)} and {tuple(h.shape)}")
    B, d_in = x.shape
    H = h.shape[1]
    dtype, device = x.dtype, x.device
    for name, t, want in (("x", x, (B, d_in)), ("h", h, (B, H)), ("c", c, (B, H)),
                          ("wx", wx, (d_in, 4 * H)), ("wh", wh, (H, 4 * H)), ("b", b, (4 * H,))):
        if t.shape != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype} like x")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
    return B, d_in, H


def _card_check(x, h, c, wx, wh, b) -> None:
    """Raise for what the CUDA kernel does not take, beyond ``_check``'s
    shapes. The contraction d_in + H has no limit: a block walks its
    quarter of it tile by tile."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"lstm_cell_op: kernel takes float32 or bfloat16, got {x.dtype}")
    for name, t in (("x", x), ("h", h), ("c", c), ("wx", wx), ("wh", wh), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell_op: {name} must be contiguous")
    if x.shape[0] > MAX_BATCH:
        raise ValueError(f"lstm_cell_op: batch {x.shape[0]} exceeds {MAX_BATCH}")


def lstm_cell_op(x, h, c, wx, wh, b):
    """One LSTM step: x ``(B, d_in)``, h/c ``(B, H)``, wx ``(d_in, 4H)``,
    wh ``(H, 4H)``, b ``(4H,)`` -> (h', c') in x's dtype, fresh tensors."""
    B, d_in, H = _check(x, h, c, wx, wh, b)
    if x.device.type == "cpu":
        return lstm_cell_ref(x, h, c, wx, wh, b)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell_op: unsupported device {x.device}")
    _card_check(x, h, c, wx, wh, b)
    fn = _FN.get(x.dtype)
    if fn is None:
        fn = _FN[x.dtype] = getattr(_build.library(), _ENTRY[x.dtype])
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    if B == 0 or H == 0:
        return h_out, c_out
    stream = _build.current_stream(x.device)
    err = fn(x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(), wh.data_ptr(),
             b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), B, d_in, H, stream)
    _build.check(err, "lstm_cell")
    LAUNCHES["lstm_cell"] += 1
    return h_out, c_out

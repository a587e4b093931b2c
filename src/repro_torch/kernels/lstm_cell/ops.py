"""Public wrapper of the fused LSTM cell kernel (``csrc/lstm_cell.cu``)
and its gradients (``csrc/lstm_cell_bwd.cu`` for one cell,
``csrc/lstm_layer_bwd.cu`` for a whole layer).

Counterpart of ``repro/kernels/lstm_cell/ops.py:16 lstm_cell_op``. CPU
tensors go to the plain versions in ``ref.py``; CUDA tensors go to the
hand-written kernels or raise. ``LAUNCHES["lstm_cell"]``,
``LAUNCHES["lstm_cell_bwd"]`` and ``LAUNCHES["lstm_layer_bwd"]`` count
kernel launches and nothing else.

With grad mode on and an input that requires grad, the op is
``LSTMCellFunction``: its forward is the kernel's training entry, which
also writes the activated gates, and its backward the pointwise kernel
followed by the matrix products (``torch.matmul``, as the JAX package
leaves them to XLA's autodiff). Otherwise (serving runs under
``torch.no_grad``) it is the serving entry, as before. Gradients are fp32
only.

``lstm_layer_op`` runs a whole layer (``repro/models/seq2seq.py:73
lstm_scan``). Under grad it is ``LSTMLayerFunction``: the forward is the
training entry once per step, writing into one gates buffer ``(T, B, 4H)``
and one cell-state buffer ``(T + 1, B, H)``; the backward is one launch of
``lstm_layer_bwd.cu`` for the recurrence, then four products over all T·B
rows. Without grad it is the serving entry once per step.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import lstm_cell_bwd_ref, lstm_cell_ref, lstm_cell_train_ref, lstm_layer_bwd_ref

LAUNCHES = {"lstm_cell": 0, "lstm_cell_bwd": 0, "lstm_layer_bwd": 0}

_ENTRY = {torch.float32: "lstm_cell_f32", torch.bfloat16: "lstm_cell_bf16"}
_FN: dict = {}  # entry name -> the library's entry point, resolved at its first launch
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
    wh ``(H, 4H)``, b ``(4H,)`` -> (h', c') in x's dtype, fresh tensors.
    Differentiable (fp32) when grad mode is on and an input requires grad."""
    _check(x, h, c, wx, wh, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, h, c, wx, wh, b)):
        if x.dtype != torch.float32:
            raise TypeError(f"lstm_cell_op: gradients are fp32 only, got {x.dtype}: every "
                            "entry point of the reference trains Seq2Seq in fp32, and a bf16 "
                            "gradient waits for one LSTM backward kernel (ROADMAP.md Queue 1 "
                            "item 3, then Queue 2 item 7)")
        return LSTMCellFunction.apply(x, h, c, wx, wh, b)
    if x.device.type == "cpu":
        return lstm_cell_ref(x, h, c, wx, wh, b)
    return _launch(x, h, c, wx, wh, b)


def _launch(x, h, c, wx, wh, b, gates=None, h_out=None, c_out=None):
    """Launch ``lstm_cell.cu`` on CUDA tensors: its serving entry, or its
    training entry (fp32) when ``gates`` is the ``(B, 4H)`` buffer for the
    activated gates. Writes h' and c' into ``h_out`` and ``c_out`` when
    given (contiguous ``(B, H)``), else into fresh tensors. Returns (h', c')."""
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell_op: unsupported device {x.device}")
    _card_check(x, h, c, wx, wh, b)
    B, d_in = x.shape
    H = h.shape[1]
    h_out = torch.empty_like(h) if h_out is None else h_out
    c_out = torch.empty_like(c) if c_out is None else c_out
    if B == 0 or H == 0:
        return h_out, c_out
    ptrs = (x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(), wh.data_ptr(),
            b.data_ptr(), h_out.data_ptr(), c_out.data_ptr())
    if gates is None:
        err = _entry(_ENTRY[x.dtype])(*ptrs, B, d_in, H, _build.current_stream(x.device))
    else:
        err = _entry("lstm_cell_train_f32")(*ptrs, gates.data_ptr(), B, d_in, H,
                                            _build.current_stream(x.device))
    _build.check(err, "lstm_cell")
    LAUNCHES["lstm_cell"] += 1
    return h_out, c_out


def _entry(name: str):
    """The library's entry point ``name``, resolved at its first launch."""
    fn = _FN.get(name)
    if fn is None:
        fn = _FN[name] = getattr(_build.library(), name)
    return fn


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def lstm_cell_train(x, h, c, wx, wh, b):
    """The forward of a training step, fp32: (h', c', gates) with the
    activated gates ``(B, 4H)`` as ``ref.lstm_cell_train_ref`` defines them.
    The kernel's training entry on the card."""
    B, _, H = _check(x, h, c, wx, wh, b)
    if x.device.type == "cpu":
        return lstm_cell_train_ref(x, h, c, wx, wh, b)
    if x.dtype != torch.float32:
        raise TypeError(f"lstm_cell_train: the training entry takes float32, got {x.dtype}")
    gates = torch.empty(B, 4 * H, dtype=torch.float32, device=x.device)
    h_out, c_out = _launch(x, h, c, wx, wh, b, gates)
    return h_out, c_out, gates


def lstm_cell_bwd(dh, dc, gates, c, c_new):
    """The cell's pointwise backward, fp32: (dz ``(B, 4H)``, dc_prev
    ``(B, H)``); ``dh`` or ``dc`` may be ``None`` (a zero gradient). The
    ``lstm_cell_bwd`` kernel on the card, ``ref.lstm_cell_bwd_ref`` on the
    CPU."""
    B, H = c_new.shape
    device = c_new.device
    for name, t, shape in (("dh", dh, (B, H)), ("dc", dc, (B, H)), ("gates", gates, (B, 4 * H)),
                           ("c", c, (B, H))):
        if t is None:
            continue
        if t.shape != shape or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"lstm_cell_bwd: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected float32 {shape} on {device}")
    if c_new.dtype != torch.float32:
        raise ValueError(f"lstm_cell_bwd: c_new is {c_new.dtype}, expected float32")
    if device.type == "cpu":
        return lstm_cell_bwd_ref(dh, dc, gates, c, c_new)
    if device.type != "cuda":
        raise ValueError(f"lstm_cell_bwd: unsupported device {device}")
    dh = None if dh is None else dh.contiguous()
    dc = None if dc is None else dc.contiguous()
    for name, t in (("gates", gates), ("c", c), ("c_new", c_new)):
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell_bwd: {name} must be contiguous")
    dz = torch.empty_like(gates)
    dc_prev = torch.empty_like(c_new)
    if B == 0 or H == 0:
        return dz.zero_(), dc_prev.zero_()
    err = _entry("lstm_cell_bwd_f32")(_ptr(dh), _ptr(dc), gates.data_ptr(), c.data_ptr(),
                                      c_new.data_ptr(), dz.data_ptr(), dc_prev.data_ptr(), B, H,
                                      _build.current_stream(device))
    _build.check(err, "lstm_cell_bwd")
    LAUNCHES["lstm_cell_bwd"] += 1
    return dz, dc_prev


class LSTMCellFunction(torch.autograd.Function):
    """``lstm_cell_op`` with a gradient: the training forward saves x, h,
    c, the weights, c' and the activated gates; the backward is the
    pointwise kernel, then dx = dz wxᵀ, dh = dz whᵀ, dwx = xᵀ dz,
    dwh = hᵀ dz, db = Σ dz. A ``None`` incoming gradient is a zero one."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        h_new, c_new, gates = lstm_cell_train(x, h, c, wx, wh, b)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, h, c, wx, wh, c_new, gates)
        return h_new, c_new

    @staticmethod
    def backward(ctx, dh_new, dc_new):
        x, h, c, wx, wh, c_new, gates = ctx.saved_tensors
        dz, dc_prev = lstm_cell_bwd(dh_new, dc_new, gates, c, c_new)
        need = ctx.needs_input_grad
        return (dz @ wx.t() if need[0] else None, dz @ wh.t() if need[1] else None,
                dc_prev if need[2] else None, x.t() @ dz if need[3] else None,
                h.t() @ dz if need[4] else None, dz.sum(0) if need[5] else None)


def lstm_layer_bwd(dhs, dh_last, dc_last, gates, cs, wh):
    """One layer's backward through time, fp32 -> (dz ``(T, B, 4H)``, dh0,
    dc0 ``(B, H)``); ``dhs``, ``dh_last`` or ``dc_last`` may be ``None`` (a
    zero gradient). One ``lstm_layer_bwd`` launch on the card,
    ``ref.lstm_layer_bwd_ref`` on the CPU."""
    T1, B, H = cs.shape
    T = T1 - 1
    device = cs.device
    for name, t, shape in (("dhs", dhs, (T, B, H)), ("dh_last", dh_last, (B, H)),
                           ("dc_last", dc_last, (B, H)), ("gates", gates, (T, B, 4 * H)),
                           ("cs", cs, (T + 1, B, H)), ("wh", wh, (H, 4 * H))):
        if t is None:
            continue
        if t.shape != shape or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"lstm_layer_bwd: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected float32 {shape} on {device}")
    if T < 1 or gates is None or wh is None:
        raise ValueError(f"lstm_layer_bwd: needs T >= 1 steps (got {T}), gates and wh")
    if device.type == "cpu":
        return lstm_layer_bwd_ref(dhs, dh_last, dc_last, gates, cs, wh)
    if device.type != "cuda":
        raise ValueError(f"lstm_layer_bwd: unsupported device {device}")
    widest = _entry("lstm_layer_bwd_max_hidden")()
    if H > widest:
        raise ValueError(f"lstm_layer_bwd: hidden {H} is wider than the kernel takes ({widest}: "
                         "a block holds an eighth of wh in shared memory)")
    dhs, dh_last, dc_last = (None if t is None else t.contiguous()
                             for t in (dhs, dh_last, dc_last))
    gates, cs, wh = gates.contiguous(), cs.contiguous(), wh.contiguous()
    dz = torch.empty_like(gates)
    dh0 = torch.empty(B, H, dtype=torch.float32, device=device)
    dc0 = torch.empty_like(dh0)
    if B == 0 or H == 0:
        return dz, dh0, dc0
    err = _entry("lstm_layer_bwd_f32")(
        _ptr(dhs), _ptr(dh_last), _ptr(dc_last), gates.data_ptr(), cs.data_ptr(),
        wh.data_ptr(), dz.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), T, B, H,
        _build.current_stream(device))
    _build.check(err, "lstm_layer_bwd")
    LAUNCHES["lstm_layer_bwd"] += 1
    return dz, dh0, dc0


def lstm_layer_op(xs, h0, c0, wx, wh, b):
    """A whole LSTM layer: xs ``(T, B, d_in)`` time-major, h0/c0 ``(B, H)``,
    the cell's weights -> (hs ``(T, B, H)``, h_T, c_T) in x's dtype.
    Differentiable (fp32) when grad mode is on and an input requires grad:
    then ``LSTMLayerFunction``; otherwise ``lstm_cell_op`` once per step."""
    if xs.dim() != 3:
        raise ValueError(f"xs must be 3-D (T, B, d_in), got {tuple(xs.shape)}")
    T = xs.shape[0]
    if T and xs.shape[1]:
        _check(xs[0], h0, c0, wx, wh, b)
    if T == 0:
        return xs.new_zeros(0, *h0.shape), h0, c0
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xs, h0, c0, wx, wh, b)):
        if xs.dtype != torch.float32:
            raise TypeError(f"lstm_layer_op: gradients are fp32 only, got {xs.dtype}: every "
                            "entry point of the reference trains Seq2Seq in fp32, and a bf16 "
                            "gradient waits for one LSTM backward kernel (ROADMAP.md Queue 1 "
                            "item 3, then Queue 2 item 7)")
        return LSTMLayerFunction.apply(xs, h0, c0, wx, wh, b)
    hs, h, c = [], h0, c0
    for x_t in xs:
        h, c = lstm_cell_op(x_t, h, c, wx, wh, b)
        hs.append(h)
    return torch.stack(hs), h, c


class LSTMLayerFunction(torch.autograd.Function):
    """``lstm_layer_op`` with a gradient. The forward runs the training
    entry once per step into ``hs (T + 1, B, H)`` (h0 first), ``cs (T + 1,
    B, H)`` (c0 first) and ``gates (T, B, 4H)``; the backward is one
    ``lstm_layer_bwd`` for dz, dh0 and dc0, then dx = dz wxᵀ,
    dwx = xᵀ dz, dwh = h_prevᵀ dz and db = Σ dz over all T·B rows. A
    ``None`` incoming gradient is a zero one."""

    @staticmethod
    def forward(ctx, xs, h0, c0, wx, wh, b):
        xs = xs.contiguous()
        T, B, _ = xs.shape
        H = h0.shape[1]
        kw = dict(dtype=torch.float32, device=xs.device)
        hs, cs, gates = torch.empty(T + 1, B, H, **kw), torch.empty(T + 1, B, H, **kw), \
            torch.empty(T, B, 4 * H, **kw)
        hs[0], cs[0] = h0, c0
        for t in range(T):
            if xs.device.type == "cpu":
                hs[t + 1], cs[t + 1], gates[t] = lstm_cell_train_ref(xs[t], hs[t], cs[t], wx, wh,
                                                                     b)
            else:
                _launch(xs[t], hs[t], cs[t], wx, wh, b, gates[t], hs[t + 1], cs[t + 1])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xs, wx, wh, hs, cs, gates)
        return hs[1:], hs[T].clone(), cs[T].clone()

    @staticmethod
    def backward(ctx, dhs, dh_last, dc_last):
        xs, wx, wh, hs, cs, gates = ctx.saved_tensors
        T, B, d_in = xs.shape
        dz, dh0, dc0 = lstm_layer_bwd(dhs, dh_last, dc_last, gates, cs, wh)
        rows = dz.reshape(T * B, -1)
        need = ctx.needs_input_grad
        return ((rows @ wx.t()).reshape(T, B, d_in) if need[0] else None,
                dh0 if need[1] else None, dc0 if need[2] else None,
                xs.reshape(T * B, d_in).t() @ rows if need[3] else None,
                hs[:T].reshape(T * B, -1).t() @ rows if need[4] else None,
                rows.sum(0) if need[5] else None)

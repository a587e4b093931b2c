"""Public wrapper of the chunkwise mLSTM kernel (``csrc/mlstm_chunk.cu``).

Counterpart of ``repro/kernels/mlstm_chunk/ops.py:14 mlstm_chunk_op`` in
the model layout (q, k, v ``(b, s, H, dh)``, gates ``(b, s, H)``), with the
state ``(C, n, m)`` in and out and any sequence length: one call serves a
block prefill and a one-token decode step. Without a gradient C is
updated IN PLACE (the returned C is the tensor given), as the KV cache is;
n and m come back as fresh tensors. CPU tensors go to the plain version in
``ref.py``; CUDA tensors go to the kernel or raise; meta tensors get empty
outputs of the kernel's shapes and dtypes. Each entry runs inside
``cost.kernel`` with the FLOPs of the reference's recurrence
(``mlstm_flops``) and its bytes.
``LAUNCHES["mlstm_chunk"]`` counts kernel launches (the serving entry's
and the training forward's, one a call) and nothing else.

With grad mode on and an input requiring grad, the op is
``MLSTMFunction`` (fp32 only) and writes nothing in place: its forward is
``csrc/mlstm_chunk_train.cu`` (``mlstm_chunk_train``: the scores once per
chunk and head, the products on the tensor cores), which returns a fresh
C and also each chunk's input state, and its backward is
``csrc/mlstm_chunk_bwd.cu`` (``mlstm_chunk_bwd``; on the CPU the plain
``mlstm_chunk_train_ref`` and ``mlstm_chunk_bwd_ref``).
``LAUNCHES["mlstm_chunk_bwd"]`` counts the backward's launches.
"""

from __future__ import annotations

import torch

from .. import _build, cost
from ..cost import contiguous
from .ref import CHUNK, mlstm_chunk_bwd_ref, mlstm_chunk_ref, mlstm_chunk_train_ref

LAUNCHES = {"mlstm_chunk": 0, "mlstm_chunk_bwd": 0}
MAX_HEAD_DIM = 1024  # a row of C in a half-warp's registers: dh/16 floats a lane


def _check(q, k, v, i_gate, f_gate, c, n, m) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be 4-D (b, s, H, dh), got {tuple(q.shape)}")
    b, s, H, dh = q.shape
    if s == 0:
        raise ValueError("mlstm_chunk_op needs at least one time step")
    want = {"k": (q.shape, k), "v": (q.shape, v), "i_gate": ((b, s, H), i_gate),
            "f_gate": ((b, s, H), f_gate), "c": ((b, H, dh, dh), c), "n": ((b, H, dh), n),
            "m": ((b, H), m)}
    for name, (shape, t) in want.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("c", c), ("n", n), ("m", m)):
        if t.dtype != torch.float32:
            raise TypeError(f"the state's {name} must be float32, got {t.dtype}")


def mlstm_chunk_op(q, k, v, i_gate, f_gate, c, n, m):
    """The mLSTM recurrence over ``s`` steps from the state (C, n, m) ->
    (h ``(b, s, H, dh)`` in q's dtype, C, new n, new m). Without a gradient
    C is written in place and returned; under grad (an input requiring
    grad) C is fresh and nothing is written."""
    _check(q, k, v, i_gate, f_gate, c, n, m)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, i_gate, f_gate, c, n, m)):
        if any(t.dtype != torch.float32 for t in (q, k, v, i_gate, f_gate)):
            raise TypeError(f"mlstm_chunk_op: gradients are fp32 only, got {q.dtype}: "
                            "the reference computes the mLSTM recurrence in fp32 (it casts "
                            "q, k and v, repro/models/xlstm.py:92 and :154), as "
                            "models/xlstm.py does before this call (ROADMAP.md Queue 1 "
                            "item 3)")
        return MLSTMFunction.apply(q, k, v, i_gate, f_gate, c, n, m)
    with cost.kernel("mlstm_chunk", mlstm_flops(*q.shape),
                     cost.nbytes(q, k, v, i_gate, f_gate, c, n, m, q, c, n, m)):
        return _serve(q, k, v, i_gate, f_gate, c, n, m)


def mlstm_flops(b: int, s: int, H: int, dh: int, backward: bool = False) -> int:
    """The dot-product FLOPs of the reference's mLSTM over ``s`` steps, as
    ``repro/models/xlstm.py:115 mlstm_scan`` dispatches, and of the products
    XLA keeps in its backward (the others are outer products, which it runs
    as multiplies). From ``2·CHUNK`` steps in whole chunks, the einsums of
    ``:130 _mlstm_chunked``, a chunk of L: the scores q·kᵀ and W·v,
    ``2·b·H·L²·dh`` each; q·C_in and the new C, ``2·b·H·L·dh²`` each; q·n_in
    and the new n, ``2·b·H·L·dh`` each; the backward two products of each
    but three of the last two's four. Else ``:92 _mlstm_step``'s C·q
    (``2·b·H·dh²``) and n·q (``2·b·H·dh``) at every step; the backward only
    C's product with the gradient, ``2·b·H·dh²`` a step."""
    if s >= 2 * CHUNK and s % CHUNK == 0:
        L = CHUNK
        square = 4 if backward else 2  # products of the L² and dh² kinds
        vector = 3 if backward else 2
        return (s // L) * 2 * b * H * (square * (L * L * dh + L * dh * dh) + vector * L * dh)
    return s * 2 * b * H * (dh * dh if backward else dh * dh + dh)


def _serve(q, k, v, i_gate, f_gate, c, n, m):
    """``mlstm_chunk_op`` without a gradient, by device."""
    if q.device.type == "cpu":
        h, c_new, n_new, m_new = mlstm_chunk_ref(q, k, v, i_gate, f_gate, c, n, m)
        c.copy_(c_new)
        return h.to(q.dtype).contiguous(), c, n_new.contiguous(), m_new.contiguous()
    if q.device.type == "meta":
        return (torch.empty(q.shape, dtype=q.dtype, device=q.device), c,
                *(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (n, m)))
    _on_card(q, "mlstm_chunk_op")
    if not c.is_contiguous():
        raise ValueError("mlstm_chunk_op: C must be contiguous (it is written in place)")
    qf, kf, vf, gi, gf = (t.float().contiguous() for t in (q, k, v, i_gate, f_gate))
    n_in, m_in = n.contiguous(), m.contiguous()
    out = torch.empty_like(qf)
    n_new, m_new = torch.empty_like(n_in), torch.empty_like(m_in)
    if out.numel() == 0:
        return out.to(q.dtype), c, n_new, m_new
    b, s, H, dh = q.shape
    err = _build.library().mlstm_chunk_f32(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), gi.data_ptr(), gf.data_ptr(),
        c.data_ptr(), n_in.data_ptr(), m_in.data_ptr(), n_new.data_ptr(), m_new.data_ptr(),
        out.data_ptr(), b, s, H, dh, _build.current_stream(q.device))
    _build.check(err, "mlstm_chunk")
    LAUNCHES["mlstm_chunk"] += 1
    return out.to(q.dtype), c, n_new, m_new


def _on_card(q, name: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[-1]} exceeds {MAX_HEAD_DIM}")


def mlstm_chunk_train(q, k, v, i_gate, f_gate, c, n, m):
    """The forward of a training step, fp32 -> (h, C, n, m, and the state
    each chunk starts from: C_in ``(nC, b, H, dh, dh)``, n_in ``(nC, b, H,
    dh)``, m_in ``(nC, b, H)``), all fresh; nothing is written in place.
    ``csrc/mlstm_chunk_train.cu`` on the card (one call of its entry: the
    scores kernel, then the rows kernel), the plain ``mlstm_chunk_train_ref``
    on the CPU."""
    _check(q, k, v, i_gate, f_gate, c, n, m)
    n_chunks = -(-q.shape[1] // CHUNK)
    with cost.kernel("mlstm_chunk", mlstm_flops(*q.shape),
                     cost.nbytes(q, k, v, i_gate, f_gate, c, n, m)
                     + 4 * (q.numel() + (1 + n_chunks) * (c.numel() + n.numel() + m.numel()))):
        return _train(q, k, v, i_gate, f_gate, c, n, m)


def _train(q, k, v, i_gate, f_gate, c, n, m):
    """``mlstm_chunk_train`` by device."""
    if q.device.type == "cpu":
        return contiguous(mlstm_chunk_train_ref(q, k, v, i_gate, f_gate, c, n, m))
    b, s, H, dh = q.shape
    if q.device.type == "meta":
        n_chunks = -(-s // CHUNK)

        def empty(*shape):
            return torch.empty(shape, dtype=torch.float32, device=q.device)

        return (empty(b, s, H, dh), empty(*c.shape), empty(*n.shape), empty(*m.shape),
                empty(n_chunks, *c.shape), empty(n_chunks, *n.shape), empty(n_chunks, *m.shape))
    _on_card(q, "mlstm_chunk_train")
    qf, kf, vf, gi, gf, c_in, n_in, m_in = (
        t.float().contiguous() for t in (q, k, v, i_gate, f_gate, c, n, m))
    n_chunks = -(-s // CHUNK)
    out = torch.empty_like(qf)
    c_out, n_out, m_out = torch.empty_like(c_in), torch.empty_like(n_in), torch.empty_like(m_in)
    c_st = torch.empty((n_chunks, *c_in.shape), dtype=torch.float32, device=q.device)
    n_st = torch.empty((n_chunks, *n_in.shape), dtype=torch.float32, device=q.device)
    m_st = torch.empty((n_chunks, *m_in.shape), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, c_out, n_out, m_out, c_st, n_st, m_st
    lib = _build.library()
    work = torch.empty(lib.mlstm_chunk_train_workspace(b, s, H, dh), dtype=torch.uint8,
                       device=q.device)
    err = lib.mlstm_chunk_train_f32(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), gi.data_ptr(), gf.data_ptr(),
        c_in.data_ptr(), n_in.data_ptr(), m_in.data_ptr(), c_out.data_ptr(), n_out.data_ptr(),
        m_out.data_ptr(), out.data_ptr(), c_st.data_ptr(), n_st.data_ptr(), m_st.data_ptr(),
        work.data_ptr(), b, s, H, dh, _build.current_stream(q.device))
    _build.check(err, "mlstm_chunk_train")
    LAUNCHES["mlstm_chunk"] += 1
    return out, c_out, n_out, m_out, c_st, n_st, m_st


def mlstm_chunk_bwd(q, k, v, i_gate, f_gate, c_in, n_in, m_in, h, dh, dc, dn, dm):
    """The backward of ``mlstm_chunk_train``, fp32 -> (dq, dk, dv, d i_gate,
    d f_gate, and dC, dn, dm of the input state), fresh. Takes the
    forward's inputs, the chunks' input states and output h, and the
    incoming gradients of h, C, n and m (each may be None: zero).
    ``csrc/mlstm_chunk_bwd.cu`` on the card (one launch of its entry),
    ``mlstm_chunk_bwd_ref`` on the CPU."""
    b, s, H, d = q.shape
    n_chunks = -(-s // CHUNK)
    for name, t, shape in (("k", k, q.shape), ("v", v, q.shape), ("i_gate", i_gate, (b, s, H)),
                           ("f_gate", f_gate, (b, s, H)), ("c_in", c_in, (n_chunks, b, H, d, d)),
                           ("n_in", n_in, (n_chunks, b, H, d)), ("m_in", m_in, (n_chunks, b, H)),
                           ("h", h, q.shape), ("dh", dh, q.shape), ("dc", dc, (b, H, d, d)),
                           ("dn", dn, (b, H, d)), ("dm", dm, (b, H)), ("q", q, q.shape)):
        if t is None and name.startswith("d"):
            continue
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"mlstm_chunk_bwd: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected float32 {tuple(shape)} on {q.device}")
    args = (q, k, v, i_gate, f_gate, c_in, n_in, m_in, h, dh, dc, dn, dm)
    with cost.kernel("mlstm_chunk_bwd", mlstm_flops(b, s, H, d, backward=True),
                     cost.nbytes(*args, q, k, v, i_gate, f_gate)
                     + cost.nbytes(c_in, n_in, m_in) // n_chunks):
        return _bwd(*args)


def _bwd(q, k, v, i_gate, f_gate, c_in, n_in, m_in, h, dh, dc, dn, dm):
    """``mlstm_chunk_bwd`` by device."""
    b, s, H, d = q.shape
    if q.device.type == "cpu":
        return contiguous(mlstm_chunk_bwd_ref(q, k, v, i_gate, f_gate, c_in, n_in, m_in, h, dh,
                                              dc, dn, dm))
    if q.device.type == "meta":
        return (*(torch.empty(t.shape, dtype=torch.float32, device=t.device)
                  for t in (q, k, v, i_gate, f_gate)),
                *(torch.empty(t.shape[1:], dtype=torch.float32, device=t.device)
                  for t in (c_in, n_in, m_in)))
    _on_card(q, "mlstm_chunk_bwd")
    q, k, v, i_gate, f_gate, c_in, n_in, m_in, h = (
        t.contiguous() for t in (q, k, v, i_gate, f_gate, c_in, n_in, m_in, h))
    dh = torch.zeros_like(q) if dh is None else dh.contiguous()
    dc, dn, dm = (None if t is None else t.contiguous() for t in (dc, dn, dm))
    grads = [torch.empty_like(t) for t in (q, k, v, i_gate, f_gate)]
    dc0 = torch.empty((b, H, d, d), dtype=torch.float32, device=q.device)
    dn0, dm0 = torch.empty_like(n_in[0]), torch.empty_like(m_in[0])
    if q.numel() == 0:
        return (*(t.zero_() for t in grads), dc0.zero_(), dn0.zero_(), dm0.zero_())
    lib = _build.library()
    work = torch.empty(lib.mlstm_chunk_bwd_workspace(b, s, H, d), dtype=torch.uint8,
                       device=q.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.mlstm_chunk_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(), f_gate.data_ptr(),
        c_in.data_ptr(), n_in.data_ptr(), m_in.data_ptr(), h.data_ptr(), dh.data_ptr(), ptr(dc),
        ptr(dn), ptr(dm), *(t.data_ptr() for t in grads), dc0.data_ptr(), dn0.data_ptr(),
        dm0.data_ptr(), work.data_ptr(), b, s, H, d, _build.current_stream(q.device))
    _build.check(err, "mlstm_chunk_bwd")
    LAUNCHES["mlstm_chunk_bwd"] += 1
    return (*grads, dc0, dn0, dm0)


class MLSTMFunction(torch.autograd.Function):
    """``mlstm_chunk_op`` with a gradient, fp32: the training forward saves
    the inputs, every chunk's input state and h; the backward recomputes
    each chunk's gates and weights from them. A ``None`` incoming gradient
    is a zero one. C comes back fresh: nothing is written in place."""

    @staticmethod
    def forward(ctx, q, k, v, i_gate, f_gate, c, n, m):
        h, c_out, n_out, m_out, c_st, n_st, m_st = mlstm_chunk_train(q, k, v, i_gate, f_gate,
                                                                     c, n, m)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, i_gate, f_gate, c_st, n_st, m_st, h)
        return h, c_out, n_out, m_out

    @staticmethod
    def backward(ctx, dh, dc, dn, dm):
        grads = mlstm_chunk_bwd(*ctx.saved_tensors, dh, dc, dn, dm)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))

"""Public wrapper of the chunkwise mLSTM kernel (``csrc/mlstm_chunk.cu``).

Counterpart of ``repro/kernels/mlstm_chunk/ops.py:14 mlstm_chunk_op`` in
the model layout (q, k, v ``(b, s, H, dh)``, gates ``(b, s, H)``), with the
state ``(C, n, m)`` in and out and any sequence length: one call serves a
block prefill and a one-token decode step. C is updated IN PLACE (the
returned C is the tensor given), as the KV cache is; n and m come back as
fresh tensors. CPU tensors go to the plain version in ``ref.py``; CUDA
tensors go to the kernel or raise. ``LAUNCHES["mlstm_chunk"]`` counts
kernel launches and nothing else. The kernel has no backward yet: on the
card a call under grad with an input that requires grad raises (on the CPU
the plain version's autograd gives the gradient).
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import mlstm_chunk_ref

LAUNCHES = {"mlstm_chunk": 0}
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
    (h ``(b, s, H, dh)`` in q's dtype, C written in place, new n, new m)."""
    _check(q, k, v, i_gate, f_gate, c, n, m)
    if q.device.type == "cpu":
        h, c_new, n_new, m_new = mlstm_chunk_ref(q, k, v, i_gate, f_gate, c, n, m)
        c.copy_(c_new)
        return h.to(q.dtype), c, n_new, m_new
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk_op: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, i_gate, f_gate, c, n, m)):
        raise NotImplementedError("mlstm_chunk_op: the kernel has no backward yet, so it takes "
                                  "no gradient on the card (ROADMAP Queue 1 item 1)")
    b, s, H, dh = q.shape
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"mlstm_chunk_op: head dim {dh} exceeds {MAX_HEAD_DIM}")
    if not c.is_contiguous():
        raise ValueError("mlstm_chunk_op: C must be contiguous (it is written in place)")
    qf, kf, vf, gi, gf = (t.float().contiguous() for t in (q, k, v, i_gate, f_gate))
    n_in, m_in = n.contiguous(), m.contiguous()
    out = torch.empty_like(qf)
    n_new, m_new = torch.empty_like(n_in), torch.empty_like(m_in)
    if out.numel() == 0:
        return out.to(q.dtype), c, n_new, m_new
    err = _build.library().mlstm_chunk_f32(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), gi.data_ptr(), gf.data_ptr(),
        c.data_ptr(), n_in.data_ptr(), m_in.data_ptr(), n_new.data_ptr(), m_new.data_ptr(),
        out.data_ptr(), b, s, H, dh, _build.current_stream(q.device))
    _build.check(err, "mlstm_chunk")
    LAUNCHES["mlstm_chunk"] += 1
    return out.to(q.dtype), c, n_new, m_new

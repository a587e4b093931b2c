"""Plain PyTorch version of the chunkwise mLSTM kernel.

The chunkwise algebra of ``repro/kernels/mlstm_chunk/mlstm_chunk.py:32
_mlstm_chunk_kernel`` (the same as ``repro/models/xlstm.py:157-185``),
with the two things serving needs beside it: the state ``(C, n, m)`` comes
in and goes out, and the last chunk may be partial. A partial chunk is
simply shorter, so positions past the sequence never touch the state (the
JAX wrapper zero-pads instead, ``repro/kernels/mlstm_chunk/ops.py:17-31``,
which decays a returned state by log σ(0) per padded step). Everything is
fp32, in the model layout. ``mlstm_step_ref`` is the one-step case in
closed form, the plain version of the CUDA kernel's decode path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 64


def mlstm_chunk_ref(q, k, v, i_gate, f_gate, c, n, m, *, chunk: int = CHUNK,
                    dtype=torch.float32):
    """q, k, v ``(b, s, H, dh)``, gate pre-activations ``(b, s, H)``, state
    C ``(b, H, dh, dh)`` (``C[v][k]``), n ``(b, H, dh)``, m ``(b, H)`` ->
    (h ``(b, s, H, dh)``, C, n, m), fresh, computed in ``dtype`` (fp32 as
    the kernel; fp64 gives a yardstick of the fp32 versions' rounding)."""
    qf, kf, vf = (t.to(dtype).transpose(1, 2) for t in (q, k, v))  # (b, H, s, dh)
    ig, fg = (t.to(dtype).transpose(1, 2) for t in (i_gate, f_gate))  # (b, H, s)
    C, n, m = c.to(dtype), n.to(dtype), m.to(dtype)
    hs = []
    for c0 in range(0, q.shape[1], chunk):
        qb, kb, vb = (t[:, :, c0 : c0 + chunk] for t in (qf, kf, vf))
        ib, fb = ig[:, :, c0 : c0 + chunk], fg[:, :, c0 : c0 + chunk]
        L = qb.shape[2]
        b_cum = torch.cumsum(F.logsigmoid(fb), dim=-1)
        x = ib - b_cum
        rmax = torch.cummax(x, dim=-1).values
        m_t = torch.maximum(b_cum + m[..., None], rmax + b_cum)
        inter = torch.exp(b_cum + m[..., None] - m_t)
        tri = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        D = torch.where(tri, torch.exp((b_cum - m_t)[..., :, None] + x[..., None, :]), 0.0)
        W = D * (qb @ kb.transpose(-1, -2))
        num = inter[..., None] * (qb @ C.transpose(-1, -2)) + W @ vb
        den = inter * (qb @ n[..., None])[..., 0] + W.sum(-1)
        hs.append(num / torch.clamp(den.abs(), min=1.0)[..., None])
        b_last = b_cum[..., -1]
        m_out = torch.maximum(b_last + m, rmax[..., -1] + b_last)
        s_out = torch.exp(b_last + m - m_out)
        w = torch.exp(b_last[..., None] - b_cum + ib - m_out[..., None])
        kw = w[..., None] * kb
        C = s_out[..., None, None] * C + vb.transpose(-1, -2) @ kw
        n = s_out[..., None] * n + kw.sum(-2)
        m = m_out
    return torch.cat(hs, dim=2).transpose(1, 2), C, n, m


def mlstm_step_ref(q, k, v, i_gate, f_gate, c, n, m):
    """One step (``s == 1``) of ``mlstm_chunk_ref`` in closed form: the
    chunk algebra at L = 1 is a rank-1 update of C. Same arguments and
    results; fp32 and fresh."""
    if q.shape[1] != 1:
        raise ValueError(f"mlstm_step_ref takes one time step, got {q.shape[1]}")
    qf, kf, vf = (t.float()[:, 0] for t in (q, k, v))  # (b, H, dh)
    it, ft = i_gate.float()[:, 0], f_gate.float()[:, 0]  # (b, H)
    C, n, m = c.float(), n.float(), m.float()
    b1 = F.logsigmoid(ft)
    x1 = it - b1
    m_new = torch.maximum(b1 + m, x1 + b1)
    decay = torch.exp(b1 + m - m_new)  # e^{b_1 + m_in - m_1}, the state's decay too
    w = torch.exp(it - m_new)  # the step's weight in the new state
    W = torch.exp(b1 - m_new + x1) * (qf * kf).sum(-1)  # D_11 (q . k)
    den = torch.clamp((decay * (qf * n).sum(-1) + W).abs(), min=1.0)
    num = decay[..., None] * (C @ qf[..., None])[..., 0] + W[..., None] * vf
    kw = w[..., None] * kf
    C_new = decay[..., None, None] * C + vf[..., :, None] * kw[..., None, :]
    n_new = decay[..., None] * n + kw
    return (num / den[..., None])[:, None], C_new, n_new, m_new

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

``mlstm_chunk_train_ref`` is the plain version of the training forward
(``csrc/mlstm_chunk_train.cu``; it also returns each chunk's input state)
and ``mlstm_chunk_bwd_ref`` that of the backward kernel
(``csrc/mlstm_chunk_bwd.cu``): the gradient of ``mlstm_chunk_ref``
written out in the chunk algebra, walking the chunks in reverse. With
``split_tf32=True`` the training forward's four products (the scores
Q Kᵀ, Q C_inᵀ, W V and C's update (w∘V)ᵀ K) are computed as the kernel's
tensor cores compute them (``kernels/tf32.py``), with w∘V in fp64 rounded
once and s_out·C added to the update's product in fp64, rounded once; and
the backward's with ``split_tf32=True`` computes the backward kernel's
products so (the scores Q Kᵀ and dh Vᵀ over 64-column slices of dh added
in slice order, Q C_inᵀ, dq's, dk's and dv's products over dh and over the
chunk's steps, and dC's update), in the kernel's association.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..tf32 import split_matmul

CHUNK = 64
SLICE = 64  # columns of dh a block of the backward's scores pass owns


def mlstm_chunk_ref(q, k, v, i_gate, f_gate, c, n, m, *, chunk: int = CHUNK,
                    dtype=torch.float32):
    """q, k, v ``(b, s, H, dh)``, gate pre-activations ``(b, s, H)``, state
    C ``(b, H, dh, dh)`` (``C[v][k]``), n ``(b, H, dh)``, m ``(b, H)`` ->
    (h ``(b, s, H, dh)``, C, n, m), fresh, computed in ``dtype`` (fp32 as
    the kernel; fp64 gives a yardstick of the fp32 versions' rounding).
    Writes none of its inputs."""
    return _chunks(q, k, v, i_gate, f_gate, c, n, m, chunk, dtype, None, False)


def mlstm_chunk_train_ref(q, k, v, i_gate, f_gate, c, n, m, *, chunk: int = CHUNK,
                          dtype=torch.float32, split_tf32: bool = False):
    """``mlstm_chunk_ref`` that also returns the state each chunk starts
    from: (h, C, n, m, C_in ``(nC, b, H, dh, dh)``, n_in ``(nC, b, H, dh)``,
    m_in ``(nC, b, H)``), in ``dtype``, nC = ⌈s / chunk⌉. ``split_tf32``
    (fp32 only) runs the four products as the kernel does."""
    if split_tf32 and dtype != torch.float32:
        raise ValueError(f"split_tf32 emulates fp32 products, got dtype {dtype}")
    states: list = []
    out = _chunks(q, k, v, i_gate, f_gate, c, n, m, chunk, dtype, states, split_tf32)
    return (*out, *(torch.stack(t) for t in zip(*states)))


def _chunks(q, k, v, i_gate, f_gate, c, n, m, chunk, dtype, states, split_tf32):
    mm = split_matmul if split_tf32 else torch.matmul
    qf, kf, vf = (t.to(dtype).transpose(1, 2) for t in (q, k, v))  # (b, H, s, dh)
    ig, fg = (t.to(dtype).transpose(1, 2) for t in (i_gate, f_gate))  # (b, H, s)
    C, n, m = c.to(dtype), n.to(dtype), m.to(dtype)
    hs = []
    for c0 in range(0, q.shape[1], chunk):
        qb, kb, vb = (t[:, :, c0 : c0 + chunk] for t in (qf, kf, vf))
        ib, fb = ig[:, :, c0 : c0 + chunk], fg[:, :, c0 : c0 + chunk]
        L = qb.shape[2]
        if states is not None:
            states.append((C, n, m))
        b_cum = torch.cumsum(F.logsigmoid(fb), dim=-1)
        x = ib - b_cum
        rmax = torch.cummax(x, dim=-1).values
        m_t = torch.maximum(b_cum + m[..., None], rmax + b_cum)
        inter = torch.exp(b_cum + m[..., None] - m_t)
        tri = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        D = torch.where(tri, torch.exp((b_cum - m_t)[..., :, None] + x[..., None, :]), 0.0)
        W = D * mm(qb, kb.transpose(-1, -2))
        num = inter[..., None] * mm(qb, C.transpose(-1, -2)) + mm(W, vb)
        den = inter * (qb @ n[..., None])[..., 0] + W.sum(-1)
        hs.append(num / torch.clamp(den.abs(), min=1.0)[..., None])
        b_last = b_cum[..., -1]
        m_out = torch.maximum(b_last + m, rmax[..., -1] + b_last)
        s_out = torch.exp(b_last + m - m_out)
        w = torch.exp(b_last[..., None] - b_cum + ib - m_out[..., None])
        kw = w[..., None] * kb
        if split_tf32:  # (w∘V)ᵀ K, then s_out·C added in fp64, each rounded once
            vw = (w.double()[..., None] * vb.double()).float()
            upd = mm(vw.transpose(-1, -2), kb)
            C = (s_out.double()[..., None, None] * C.double() + upd.double()).float()
        else:
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


def _maximum_weights(a, b):
    """The share of ``torch.maximum(a, b)``'s gradient that goes to a: 1
    where a is larger, 1/2 at a tie, as autograd splits it."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0)).to(a.dtype)


def _split_scores(a, b):
    """a bᵀ over the last axis in 3xTF32, by ``SLICE``-wide slices of it
    added in slice order, as the backward kernel's scores pass computes it."""
    out = None
    for e0 in range(0, a.shape[-1], SLICE):
        part = split_matmul(a[..., e0 : e0 + SLICE], b[..., e0 : e0 + SLICE].transpose(-1, -2))
        out = part if out is None else out + part
    return out


def mlstm_chunk_bwd_ref(q, k, v, i_gate, f_gate, c_in, n_in, m_in, h, dh, dc=None, dn=None,
                        dm=None, *, chunk: int = CHUNK, dtype=torch.float32,
                        split_tf32: bool = False):
    """The gradient of ``mlstm_chunk_ref``. Takes the forward's inputs, the
    state each chunk started from (``c_in``, ``n_in``, ``m_in`` as
    ``mlstm_chunk_train_ref`` returns them), its output ``h`` and the
    incoming gradients of h and of the returned C, n and m (None: zero) ->
    (dq, dk, dv, d i_gate, d f_gate, and dC, dn, dm of the input state),
    computed in ``dtype``.

    The chunks are walked in reverse, carrying dC, dn and dm; each chunk
    recomputes its gates, D, W, the denominators, s_out and w from its
    input state. With g_t = max(|den_t|, 1) and a max's gradient split at
    a tie as autograd splits it (the running max's to the latest index):
    dnum_t = dh_t / g_t, dden_t = -(dh_t · h_t) / g_t · sign(den_t)
    [|den_t| >= 1], dW = dnum V^T + dden (j <= t), and the state's
    C_out = s_out C_in + Σ_j w_j v_j k_j^T gives dC_in = s_out dC_out +
    Σ_t inter_t dnum_t q_t^T.

    ``split_tf32`` (fp32 only) computes the products the kernel runs on
    the tensor cores as it does: 1/g scales dh V^T, dh and W where the
    kernel scales them, and a_t = (inter_t / g_t) dh_t."""
    if split_tf32 and dtype != torch.float32:
        raise ValueError(f"split_tf32 emulates fp32 products, got dtype {dtype}")
    mm = split_matmul if split_tf32 else torch.matmul
    b, s, H, d = q.shape
    qf, kf, vf, hf = (t.to(dtype).transpose(1, 2) for t in (q, k, v, h))  # (b, H, s, dh)
    ig, fg = (t.to(dtype).transpose(1, 2) for t in (i_gate, f_gate))  # (b, H, s)
    dhf = torch.zeros_like(qf) if dh is None else dh.to(dtype).transpose(1, 2)
    dC = torch.zeros(b, H, d, d, dtype=dtype, device=q.device) if dc is None else dc.to(dtype)
    dN = torch.zeros(b, H, d, dtype=dtype, device=q.device) if dn is None else dn.to(dtype)
    dM = torch.zeros(b, H, dtype=dtype, device=q.device) if dm is None else dm.to(dtype)
    grads = {name: torch.zeros_like(t) for name, t in (("q", qf), ("k", kf), ("v", vf),
                                                       ("i", ig), ("f", fg))}
    starts = list(range(0, s, chunk))
    for ci in reversed(range(len(starts))):
        sl = slice(starts[ci], starts[ci] + chunk)
        C, n, m = c_in[ci].to(dtype), n_in[ci].to(dtype), m_in[ci].to(dtype)
        qb, kb, vb, hb, dhb = (t[:, :, sl] for t in (qf, kf, vf, hf, dhf))
        ib, fb = ig[:, :, sl], fg[:, :, sl]
        L = qb.shape[2]
        # the forward's chunk algebra again
        b_cum = torch.cumsum(F.logsigmoid(fb), dim=-1)
        x = ib - b_cum
        rmax, ridx = torch.cummax(x, dim=-1)
        m_a, m_b = b_cum + m[..., None], rmax + b_cum
        m_t = torch.maximum(m_a, m_b)
        inter = torch.exp(b_cum + m[..., None] - m_t)
        tri = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        D = torch.where(tri, torch.exp((b_cum - m_t)[..., :, None] + x[..., None, :]), 0.0)
        W = D * (_split_scores(qb, kb) if split_tf32 else qb @ kb.transpose(-1, -2))
        qn = (qb @ n[..., None])[..., 0]
        den = inter * qn + W.sum(-1)
        g = torch.clamp(den.abs(), min=1.0)
        b_last = b_cum[..., -1]
        o_a, o_b = b_last + m, rmax[..., -1] + b_last
        m_out = torch.maximum(o_a, o_b)
        s_out = torch.exp(b_last + m - m_out)
        w = torch.exp(b_last[..., None] - b_cum + ib - m_out[..., None])
        # h_t = num_t / g_t
        dden = -(dhb * hb).sum(-1) / g * torch.sign(den) * (den.abs() >= 1.0)
        if split_tf32:
            inv = 1.0 / g
            dnum = dhb * inv[..., None]
            dW = torch.where(tri, _split_scores(dhb, vb) * inv[..., None] + dden[..., None], 0.0)
            a_t = (inter * inv)[..., None] * dhb
        else:
            dnum = dhb / g[..., None]
            dW = torch.where(tri, dnum @ vb.transpose(-1, -2) + dden[..., None], 0.0)
            a_t = inter[..., None] * dnum
        dS, P = dW * D, dW * W
        dinter = (dnum * mm(qb, C.transpose(-1, -2))).sum(-1) + dden * qn
        # the state's update C_out = s_out C_in + Σ_j w_j v_j k_j^T, n likewise
        dCk = mm(kb, dC.transpose(-1, -2))  # (L, dh): row j is dC_out k_j
        dw = (vb * dCk).sum(-1) + (kb @ dN[..., None])[..., 0]
        e_n = (inter * dden)[..., None] * n[..., None, :]
        if split_tf32:  # the kernel's order: the product over dh, then the chunk's
            dq = mm(a_t, C) + mm(dS, kb) + e_n
            dk = (mm(w[..., None] * vb, dC) + mm(dS.transpose(-1, -2), qb)
                  + w[..., None] * dN[..., None, :])
            dv = w[..., None] * dCk + mm((W * inv[..., None]).transpose(-1, -2), dhb)
        else:
            dq = a_t @ C + e_n + dS @ kb
            dk = dS.transpose(-1, -2) @ qb + w[..., None] * (vb @ dC + dN[..., None, :])
            dv = W.transpose(-1, -2) @ dnum + w[..., None] * dCk
        ds = (dC * C).sum((-1, -2)) + (dN * n).sum(-1)
        dC = s_out[..., None, None] * dC + mm(a_t.transpose(-1, -2), qb)
        dN = s_out[..., None] * dN + ((inter * dden)[..., None, :] @ qb)[..., 0, :]
        # the gates, through the exponents of inter, D, s_out and w and the maxima
        Q, R, Pw = dinter * inter, ds * s_out, dw * w
        rows = P.sum(-1) + Q
        db = rows.clone()
        dx = P.sum(-2) + Pw
        dm_t = -rows
        dmo = dM - R - Pw.sum(-1)
        db[..., -1] += R + Pw.sum(-1) + dmo
        share = _maximum_weights(o_a, o_b)
        dm_in = Q.sum(-1) + R + share * dmo
        dr = torch.zeros_like(x)
        dr[..., -1] = (1 - share) * dmo
        share_t = _maximum_weights(m_a, m_b)
        db = db + dm_t
        dm_in = dm_in + (share_t * dm_t).sum(-1)
        dr = dr + (1 - share_t) * dm_t
        dx = dx.scatter_add(-1, ridx, dr)
        db = db - dx
        dlf = torch.flip(torch.cumsum(torch.flip(db, (-1,)), -1), (-1,))
        grads["q"][:, :, sl], grads["k"][:, :, sl], grads["v"][:, :, sl] = dq, dk, dv
        grads["i"][:, :, sl], grads["f"][:, :, sl] = dx, dlf * torch.sigmoid(-fb)
        dM = dm_in
    out = [grads[name].transpose(1, 2) for name in "qkvif"]
    return (*out, dC, dN, dM)

"""Plain PyTorch versions of the fused LSTM cell kernel, of its
pointwise backward (``csrc/lstm_cell_bwd.cu``) and of one layer's
backward through time (``csrc/lstm_layer_bwd.cu``).

Counterpart of ``repro/kernels/lstm_cell/ref.py:10 lstm_cell_ref`` and
``repro/models/seq2seq.py:63 lstm_cell``, on the model's own layouts:
wx ``(d_in, 4H)``, wh ``(H, 4H)``, b ``(4H,)``, gate order i, f, g, o,
forget bias +1. Like the CUDA kernel it accumulates in fp32 whatever the
input dtype, and returns outputs in the dtype of ``x``.
"""

from __future__ import annotations

import torch


def _cell(x, h, c, wx, wh, b):
    f32 = torch.float32
    z = x.to(f32) @ wx.to(f32) + h.to(f32) @ wh.to(f32) + b.to(f32)
    i, f, g, o = z.chunk(4, dim=-1)
    gates = torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.tanh(g), torch.sigmoid(o)
    gi, gf, gg, go = gates
    c_new = gf * c.to(f32) + gi * gg
    h_new = go * torch.tanh(c_new)
    return h_new.to(x.dtype), c_new.to(x.dtype), gates


def lstm_cell_ref(x, h, c, wx, wh, b):
    h_new, c_new, _ = _cell(x, h, c, wx, wh, b)
    return h_new, c_new


def lstm_cell_train_ref(x, h, c, wx, wh, b):
    """(h', c', gates): the cell, and the activated gates ``(B, 4H)`` fp32
    ``[sigmoid(i) | sigmoid(f + 1) | tanh(g) | sigmoid(o)]`` that the
    training entry of the kernel writes for the backward."""
    h_new, c_new, gates = _cell(x, h, c, wx, wh, b)
    return h_new, c_new, torch.cat(gates, dim=-1)


def lstm_cell_bwd_ref(dh, dc, gates, c, c_new):
    """The cell's pointwise backward, fp32: (dz ``(B, 4H)`` in ``[i|f|g|o]``
    order, dc_prev ``(B, H)``) from the incoming gradients of h' and c'
    (either may be ``None``: a zero gradient), the activated gates, c and
    c'. The kernel's arithmetic, in its order."""
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    tc = torch.tanh(c_new)
    dhv = torch.zeros_like(c_new) if dh is None else dh
    dct = (torch.zeros_like(c_new) if dc is None else dc) + dhv * go * (1.0 - tc * tc)
    dz = torch.cat([dct * gg * gi * (1.0 - gi), dct * c * gf * (1.0 - gf),
                    dct * gi * (1.0 - gg * gg), dhv * tc * go * (1.0 - go)], dim=-1)
    return dz, dct * gf


def lstm_layer_bwd_ref(dhs, dh_last, dc_last, gates, cs, wh):
    """One layer's backward through time in the inputs' dtype (fp32; fp64
    as a yardstick): (dz ``(T, B, 4H)``, dh0
    ``(B, H)``, dc0 ``(B, H)``) from the cotangents of the hidden states
    ``dhs (T, B, H)`` and of the final state ``dh_last``, ``dc_last``
    ``(B, H)`` (each may be ``None``: a zero gradient), the activated gates
    ``(T, B, 4H)`` and the cell states ``cs (T + 1, B, H)`` (c_0 first) of
    the training forward, and ``wh (H, 4H)``. Walking t = T-1 .. 0, the
    hidden state's gradient is ``dhs[t]`` (plus ``dh_last`` at the last
    step) plus ``dz[t + 1] @ whᵀ``, the cell state's is ``dc_last`` at the
    last step and the previous step's ``dc_prev`` after it; then the cell's
    pointwise backward. ``dh0 = dz[0] @ whᵀ``, ``dc0`` the last ``dc_prev``.
    T >= 1."""
    T, B, H = cs.shape[0] - 1, cs.shape[1], cs.shape[2]
    dz = torch.empty(T, B, 4 * H, dtype=gates.dtype, device=cs.device)
    dh_next = None  # dz[t + 1] @ whᵀ
    dc = dc_last
    for t in range(T - 1, -1, -1):
        terms = [d for d in (None if dhs is None else dhs[t],
                             dh_last if t == T - 1 else None, dh_next) if d is not None]
        dh = None
        for d in terms:
            dh = d if dh is None else dh + d
        dz[t], dc = lstm_cell_bwd_ref(dh, dc, gates[t], cs[t], cs[t + 1])
        dh_next = dz[t] @ wh.t()
    return dz, dh_next, dc

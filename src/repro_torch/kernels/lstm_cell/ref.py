"""Plain PyTorch versions of the fused LSTM cell kernel and of its
pointwise backward (``csrc/lstm_cell_bwd.cu``).

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

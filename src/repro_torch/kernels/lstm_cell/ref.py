"""Plain PyTorch version of the fused LSTM cell kernel.

Counterpart of ``repro/kernels/lstm_cell/ref.py:10 lstm_cell_ref`` and
``repro/models/seq2seq.py:63 lstm_cell``, on the model's own layouts:
wx ``(d_in, 4H)``, wh ``(H, 4H)``, b ``(4H,)``, gate order i, f, g, o,
forget bias +1. Like the CUDA kernel it accumulates in fp32 whatever the
input dtype, and returns outputs in the dtype of ``x``.
"""

from __future__ import annotations

import torch


def lstm_cell_ref(x, h, c, wx, wh, b):
    f32 = torch.float32
    z = x.to(f32) @ wx.to(f32) + h.to(f32) @ wh.to(f32) + b.to(f32)
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c.to(f32) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(x.dtype), c_new.to(x.dtype)

"""Plain PyTorch version of the RG-LRU recurrence kernel.

Counterpart of ``repro/kernels/rg_lru/ref.py:8 rg_lru_ref``, which runs
``jax.lax.associative_scan``; this one walks the sequence in order, as the
Pallas kernel's ``fori_loop`` and the CUDA kernel do: h_t = a_t·h_{t−1} + b_t
in fp32 from ``h0`` (zero when None). ``rg_lru_bwd_ref`` is the plain
version of the backward kernel (``csrc/rg_lru_bwd.cu``), the reverse scan
written out.
"""

from __future__ import annotations

import torch


def rg_lru_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b ``(batch, seq, d)``, h0 ``(batch, d)`` -> (every h_t
    ``(batch, seq, d)``, the last h ``(batch, d)``), both fp32."""
    a, b = a.float(), b.float()
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0.float()
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h


def rg_lru_bwd_ref(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor | None,
                   dh: torch.Tensor | None, dlast: torch.Tensor | None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The gradients of ``rg_lru_ref`` given the forward's every h_t ``h``
    and the incoming dh ``(batch, seq, d)`` and d(last) ``(batch, d)``
    (None: zero) -> (da, db, dh0; dh0 None without h0), fp32. A reverse
    scan: g_T = dh_T + d(last), g_t = dh_t + a_{t+1}·g_{t+1},
    da_t = g_t·h_{t−1}, db_t = g_t, dh0 = a_1·g_1."""
    a, h = a.float(), h.float()
    g = torch.zeros_like(a[:, 0]) if dlast is None else dlast.float()
    da, db = torch.empty_like(a), torch.empty_like(a)
    for t in reversed(range(a.shape[1])):
        if dh is not None:
            g = g + dh[:, t].float()
        db[:, t] = g
        if t > 0:
            da[:, t] = g * h[:, t - 1]
        else:
            da[:, t] = g * h0.float() if h0 is not None else 0.0
        g = a[:, t] * g
    return da, db, (g if h0 is not None else None)

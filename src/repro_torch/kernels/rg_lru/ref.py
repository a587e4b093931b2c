"""Plain PyTorch version of the RG-LRU recurrence kernel.

Counterpart of ``repro/kernels/rg_lru/ref.py:8 rg_lru_ref``, which runs
``jax.lax.associative_scan``; this one walks the sequence in order, as the
Pallas kernel's ``fori_loop`` and the CUDA kernel do: h_t = a_t·h_{t−1} + b_t
in fp32 from ``h0`` (zero when None).
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

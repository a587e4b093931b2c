"""Public wrapper of the RG-LRU recurrence kernel (``csrc/rg_lru.cu``).

Counterpart of ``repro/kernels/rg_lru/ops.py:14 rg_lru_op``: the
recurrence runs in fp32 and the outputs come back in the input's dtype.
It also returns the last h in fp32, the Griffin block's recurrent state,
so the block needs no slice and copy of its own. CPU tensors go to the
plain version in ``ref.py``; CUDA tensors go to the kernel or raise. The
kernel reads fp32 or bf16 a and b and writes h in their dtype, so either is
one launch; other dtypes are cast to fp32 around it, as the JAX op casts.
``LAUNCHES["rg_lru"]`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import rg_lru_ref

LAUNCHES = {"rg_lru": 0}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/rg_lru.cu's codes


def _check(a, b, h0) -> None:
    if a.dim() != 3:
        raise ValueError(f"a must be 3-D (batch, seq, d), got {tuple(a.shape)}")
    if b.shape != a.shape:
        raise ValueError(f"b has shape {tuple(b.shape)}, expected {tuple(a.shape)} like a")
    if a.shape[1] == 0:
        raise ValueError("rg_lru_op needs at least one time step")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if h0 is not None:
        if tuple(h0.shape) != (a.shape[0], a.shape[2]):
            raise ValueError(f"h0 has shape {tuple(h0.shape)}, expected "
                             f"{(a.shape[0], a.shape[2])}")
        if h0.device != a.device:
            raise ValueError(f"h0 is on {h0.device}, a on {a.device}")


def rg_lru_op(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t·h_{t−1} + b_t over a, b ``(batch, seq, d)`` from h0
    ``(batch, d)`` (zero when None) -> (h ``(batch, seq, d)`` in a's dtype,
    the last h ``(batch, d)`` in fp32), fresh tensors."""
    _check(a, b, h0)
    if a.device.type == "cpu":
        h, last = rg_lru_ref(a, b, h0)
        return h.to(a.dtype), last
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru_op: unsupported device {a.device}")
    batch, seq, d = a.shape
    if batch > 65535:
        raise ValueError(f"rg_lru_op: batch {batch} exceeds the grid")
    if a.dtype == b.dtype == torch.bfloat16:
        ac, bc = a.contiguous(), b.contiguous()
    else:
        ac, bc = a.float().contiguous(), b.float().contiguous()
    hf = None if h0 is None else h0.float().contiguous()
    out = torch.empty_like(ac)
    last = torch.empty((batch, d), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out.to(a.dtype), last
    err = _build.library().rg_lru(
        ac.data_ptr(), bc.data_ptr(), None if hf is None else hf.data_ptr(),
        out.data_ptr(), last.data_ptr(), _DTYPE[ac.dtype], batch, seq, d,
        _build.current_stream(a.device))
    _build.check(err, "rg_lru")
    LAUNCHES["rg_lru"] += 1
    return out.to(a.dtype), last

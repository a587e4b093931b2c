"""Shared model building blocks of the port."""

from __future__ import annotations

import torch


def truncated_normal(shape, scale: float, generator: torch.Generator,
                     dtype=torch.float32) -> torch.Tensor:
    """``scale`` times a standard normal truncated to ±2σ, drawn in fp32 on
    the generator's device and cast to ``dtype``. Counterpart of
    ``repro/models/blocks.py:19 truncated_normal`` (another random stream)."""
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (scale * out).to(dtype)

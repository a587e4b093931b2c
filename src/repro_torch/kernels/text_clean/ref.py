"""Plain PyTorch versions of the two text kernels.

Counterparts of ``repro/kernels/text_clean/ref.py:10 text_clean_ref`` (the
character cleaning kernel) and ``:25 text_scan_ref`` (the scan pass), on
the flat layout the CUDA kernels take: a uint8 buffer whose row ``r`` is
bytes ``[offsets[r], offsets[r + 1])``. A ``(rows, width)`` matrix is the
special case ``offsets = arange(rows + 1) * width``.
"""

from __future__ import annotations

import torch


def _row_cumsum(delta: torch.Tensor, offsets: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum of ``delta`` that restarts at every row."""
    total = torch.cumsum(delta, 0)
    before = torch.cat([total.new_zeros(1), total])[offsets[:-1]]
    return total - before[row]


def _clean(x: torch.Tensor, depth: torch.Tensor | None) -> torch.Tensor:
    """Lowercase ``x`` (int64 bytes); keep a-z bytes where ``depth`` (None
    without the HTML span) is 0 and the byte is not ``>``; the rest -> space."""
    x = torch.where((x >= 65) & (x <= 90), x + 32, x)
    keep = (x >= 97) & (x <= 122)
    if depth is not None:
        keep &= depth == 0
    return torch.where(keep, x, 32).to(torch.uint8)


def text_clean_ref(rows, *, strip_html: bool = True) -> torch.Tensor:
    """The cleaning kernel over a ``(n, width)`` uint8 matrix: lowercase,
    ``depth == 0`` survival of the ``<...>`` span, non-letters to space.
    ('>' is never a letter, so the kernel's ``x != '>'`` test is implied.)"""
    x = rows.to(torch.int64)
    depth = torch.cumsum((x == 60).long() - (x == 62).long(), 1) if strip_html else None
    return _clean(x, depth)


def text_clean_flat_ref(buf, offsets, *, strip_html: bool = True) -> torch.Tensor:
    """:func:`text_clean_ref` over the flat layout."""
    x = buf.to(torch.int64)
    depth = None
    if strip_html:
        lens = offsets[1:] - offsets[:-1]
        row = torch.repeat_interleave(torch.arange(lens.numel(), device=buf.device), lens,
                                      output_size=buf.numel())
        depth = _row_cumsum((x == 60).long() - (x == 62).long(), offsets, row)
    return _clean(x, depth)


def text_scan_ref(buf, offsets, *, lower: bool = True, strip_html: bool = False,
                  strip_parens: bool = False) -> torch.Tensor:
    """Value-preserving scan: removed span bytes become 0, ``depth <= 0``
    survival, every closer dies, paren span masked by the HTML aliveness."""
    x = buf.to(torch.int64)
    if lower:
        x = torch.where((x >= 65) & (x <= 90), x + 32, x)
    lens = offsets[1:] - offsets[:-1]
    row = torch.repeat_interleave(torch.arange(lens.numel(), device=buf.device), lens,
                                  output_size=buf.numel())
    alive = torch.ones_like(x, dtype=torch.bool)
    if strip_html:
        depth = _row_cumsum((x == 60).long() - (x == 62).long(), offsets, row)
        alive = (depth <= 0) & (x != 62)
    if strip_parens:
        opens = (x == 40) & alive
        closes = (x == 41) & alive
        depth = _row_cumsum(opens.long() - closes.long(), offsets, row)
        alive = alive & (depth <= 0) & ~closes
    return torch.where(alive, x, 0).to(torch.uint8)

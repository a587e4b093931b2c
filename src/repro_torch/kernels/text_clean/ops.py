"""Public wrappers of the cleaning scan-pass kernel (``csrc/text_scan.cu``).

Counterpart of ``repro/kernels/text_clean/ops.py:39 text_scan_op`` and
``:90 scan_flat``. CPU tensors go to the plain version in ``ref.py``; CUDA
tensors go to the hand-written kernel or raise. ``LAUNCHES["text_scan"]``
counts kernel launches and nothing else.

Unlike the TPU bridge, ``scan_flat`` pads nothing to 128 lanes and never
declines: the kernel walks the flat ``\\x00``-separated buffer by row
offsets, whatever the row lengths.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ...device import resolve
from .ref import text_scan_ref

LAUNCHES = {"text_scan": 0}


def text_scan_op(buf, offsets, *, lower: bool = True, strip_html: bool = False,
                 strip_parens: bool = False) -> torch.Tensor:
    """Scan pass over a flat uint8 buffer ``buf`` ``(N,)`` whose row ``r`` is
    ``buf[offsets[r]:offsets[r + 1]]``; ``offsets`` is int64 ``(rows + 1,)``,
    non-decreasing, from 0 to N. Returns a fresh uint8 ``(N,)`` buffer in
    which removed bytes are 0."""
    if buf.dim() != 1 or buf.dtype != torch.uint8:
        raise TypeError(f"buf must be 1-D uint8, got {buf.dtype} {tuple(buf.shape)}")
    if offsets.dim() != 1 or offsets.dtype != torch.int64 or offsets.numel() < 1:
        raise TypeError(f"offsets must be 1-D int64 with rows + 1 entries, got "
                        f"{offsets.dtype} {tuple(offsets.shape)}")
    if offsets.device != buf.device:
        raise ValueError(f"offsets are on {offsets.device}, buf on {buf.device}")
    flags = dict(lower=lower, strip_html=strip_html, strip_parens=strip_parens)
    if buf.device.type == "cpu":
        return text_scan_ref(buf, offsets, **flags)
    if buf.device.type != "cuda":
        raise ValueError(f"text_scan_op: unsupported device {buf.device}")
    if not (buf.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("text_scan_op: buf and offsets must be contiguous")
    out = torch.empty_like(buf)
    n_rows = offsets.numel() - 1
    if n_rows == 0 or buf.numel() == 0:
        return out
    lib = _build.library()
    err = lib.text_scan(buf.data_ptr(), out.data_ptr(), offsets.data_ptr(), n_rows,
                        int(lower), int(strip_html), int(strip_parens),
                        _build.current_stream(buf.device))
    _build.check(err, "text_scan")
    LAUNCHES["text_scan"] += 1
    return out


def scan_flat(buf: np.ndarray, *, lower: bool = True, strip_html: bool = False,
              strip_parens: bool = False, device=None) -> np.ndarray:
    """Run the scan pass over a flat ``\\x00``-terminated row buffer on
    ``device`` (the card unless the caller names another) and compact the
    removed bytes away on the device: the same bytes as the sequential
    ``span_strip`` passes of the host."""
    if buf.dtype != np.uint8 or buf.ndim != 1:
        raise TypeError(f"buf must be a 1-D uint8 array, got {buf.dtype} {buf.shape}")
    if buf.size == 0:
        return buf.copy()
    if buf[-1] != 0:
        raise ValueError("scan_flat: rows must be \\x00-terminated")
    t = torch.tensor(buf, device=resolve(device))
    sep = t == 0
    ends = torch.nonzero(sep).flatten() + 1
    offsets = torch.cat([ends.new_zeros(1), ends])
    out = text_scan_op(t, offsets, lower=lower, strip_html=strip_html,
                       strip_parens=strip_parens)
    return out[(out != 0) | sep].cpu().numpy()


def pack_rows(rows: list[str], width: int | None = None) -> np.ndarray:
    """Pad/truncate UTF-8 rows into a (n, width) uint8 matrix (space pad).
    Copy of ``repro/kernels/text_clean/ops.py:47 pack_rows``."""
    enc = [r.encode("utf-8", errors="ignore") for r in rows]
    width = width or max((len(e) for e in enc), default=1)
    out = np.full((len(rows), width), 32, dtype=np.uint8)
    for i, e in enumerate(enc):
        out[i, : min(len(e), width)] = np.frombuffer(e[:width], dtype=np.uint8)
    return out

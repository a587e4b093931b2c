"""Public wrappers of the two text kernels (``csrc/text_scan.cu``,
``csrc/text_clean.cu``).

Counterparts of ``repro/kernels/text_clean/ops.py``: ``text_scan_op``
(``:39``) and ``scan_flat`` (``:90``) for the serving chain's scan pass;
``text_clean_op`` (``:30``), ``unpack_rows`` (``:57``) and ``clean_rows``
(``:65``) for the character cleaning of ``DeviceCleaner``. CPU tensors go
to the plain versions in ``ref.py``; CUDA tensors go to the hand-written
kernels or raise. ``LAUNCHES[name]`` counts each kernel's launches and
nothing else, under a lock: the planner's shard threads launch
``text_scan`` concurrently.

Unlike the TPU bridge, nothing is padded to 128 lanes or declined: the
kernels walk flat buffers by row offsets, whatever the row lengths.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import _build
from ...core.bytesops import collapse_spaces, unflatten
from ...device import resolve
from .ref import text_clean_flat_ref, text_clean_ref, text_scan_ref

LAUNCHES = {"text_scan": 0, "text_clean": 0}
_LAUNCHES_LOCK = threading.Lock()


def _count(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def text_scan_op(buf, offsets, *, lower: bool = True, strip_html: bool = False,
                 strip_parens: bool = False) -> torch.Tensor:
    """Scan pass over a flat uint8 buffer ``buf`` ``(N,)`` whose row ``r`` is
    ``buf[offsets[r]:offsets[r + 1]]``; ``offsets`` is int64 ``(rows + 1,)``,
    non-decreasing, from 0 to N. Returns a fresh uint8 ``(N,)`` buffer in
    which removed bytes are 0."""
    _check_flat("text_scan_op", buf, offsets)
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
    _count("text_scan")
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


def _check_flat(name: str, buf, offsets) -> None:
    if buf.dim() != 1 or buf.dtype != torch.uint8:
        raise TypeError(f"buf must be 1-D uint8, got {buf.dtype} {tuple(buf.shape)}")
    if offsets.dim() != 1 or offsets.dtype != torch.int64 or offsets.numel() < 1:
        raise TypeError(f"offsets must be 1-D int64 with rows + 1 entries, got "
                        f"{offsets.dtype} {tuple(offsets.shape)}")
    if offsets.device != buf.device:
        raise ValueError(f"{name}: offsets are on {offsets.device}, buf on {buf.device}")


def _launch_clean(buf, offsets, n_rows: int, width: int, strip_html: bool) -> torch.Tensor:
    """The CUDA kernel over ``n_rows`` rows of ``buf``: by ``offsets``, or
    of ``width`` bytes each when ``offsets`` is None."""
    if not buf.is_contiguous() or (offsets is not None and not offsets.is_contiguous()):
        raise ValueError("text_clean: buf and offsets must be contiguous")
    out = torch.empty_like(buf)
    if n_rows == 0 or buf.numel() == 0:
        return out
    lib = _build.library()
    err = lib.text_clean(buf.data_ptr(), out.data_ptr(),
                         None if offsets is None else offsets.data_ptr(), n_rows, width,
                         int(strip_html), _build.current_stream(buf.device))
    _build.check(err, "text_clean")
    _count("text_clean")
    return out


def text_clean_flat(buf, offsets, *, strip_html: bool = True) -> torch.Tensor:
    """Character cleaning over a flat uint8 buffer ``buf`` ``(N,)`` whose row
    ``r`` is ``buf[offsets[r]:offsets[r + 1]]``; ``offsets`` is int64
    ``(rows + 1,)``, non-decreasing, from 0 to N. Returns a fresh uint8
    ``(N,)`` buffer of a-z and spaces."""
    _check_flat("text_clean_flat", buf, offsets)
    if buf.device.type == "cpu":
        return text_clean_flat_ref(buf, offsets, strip_html=strip_html)
    if buf.device.type != "cuda":
        raise ValueError(f"text_clean_flat: unsupported device {buf.device}")
    return _launch_clean(buf, offsets, offsets.numel() - 1, 0, strip_html)


def text_clean_op(rows, *, strip_html: bool = True) -> torch.Tensor:
    """The cleaning kernel over a ``(n, width)`` uint8 matrix of padded rows
    (``repro/kernels/text_clean/ops.py:30``). Returns a fresh matrix."""
    if rows.dim() != 2 or rows.dtype != torch.uint8:
        raise TypeError(f"rows must be a 2-D uint8 matrix, got {rows.dtype} {tuple(rows.shape)}")
    n, width = rows.shape
    if rows.device.type == "cpu":
        return text_clean_ref(rows, strip_html=strip_html)
    if rows.device.type != "cuda":
        raise ValueError(f"text_clean_op: unsupported device {rows.device}")
    return _launch_clean(rows.contiguous().view(-1), None, n, width, strip_html).view(n, width)


def unpack_rows(mat) -> list[str]:
    """Cleaned matrix rows -> strings with whitespace runs collapsed.
    Copy of ``repro/kernels/text_clean/ops.py:57 unpack_rows``."""
    out = []
    for row in np.asarray(mat):
        s = row.tobytes().decode("utf-8", errors="ignore")
        out.append(" ".join(s.split()))
    return out


def clean_flat(rows: list[str], *, strip_html: bool = True, device=None) -> np.ndarray:
    """:func:`clean_rows` as one flat ``\\x00``-terminated row buffer
    (``repro_torch.core.bytesops.flatten`` of its strings), the form the
    host word tail of ``DeviceCleaner`` takes. Each row goes to the kernel
    with its terminator, which becomes a space there and is put back after;
    nothing is padded."""
    enc = [r.encode("utf-8", errors="ignore") for r in rows]
    if not enc:
        return np.zeros(0, dtype=np.uint8)
    ends = np.cumsum([len(e) + 1 for e in enc], dtype=np.int64)
    dev = resolve(device)
    buf = torch.frombuffer(bytearray(b"\x00".join(enc) + b"\x00"), dtype=torch.uint8).to(dev)
    offsets = torch.from_numpy(np.concatenate([[0], ends])).to(dev)
    out = text_clean_flat(buf, offsets, strip_html=strip_html)
    out[offsets[1:] - 1] = 0
    return collapse_spaces(out.cpu().numpy())


def clean_rows(rows: list[str], *, strip_html: bool = True, device=None) -> list[str]:
    """Clean a list of rows on ``device`` (the card unless the caller names
    another): lowercase, HTML span, letters only, whitespace collapsed.
    ``repro/kernels/text_clean/ops.py:65``, except that a column of empty
    rows gives empty rows: the reference's ``pack_rows`` makes a matrix of
    width 0 there, and its Pallas grid divides by it."""
    return unflatten(clean_flat(rows, strip_html=strip_html, device=device))

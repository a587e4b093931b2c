"""Public wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention/ops.py:19
flash_attention_op`` with two more runtime arguments, ``q_offset`` and
``kv_len``, so that one call serves a full sequence, a block prefill into
a KV cache and a one-token decode step. Tensors stay in the model layout
``(b, s, heads, hd)``; the kernel reads them through their strides, so a
KV cache is read in place. CPU tensors go to the plain version in
``ref.py``; CUDA tensors go to the kernel or raise.
``LAUNCHES["flash_attention"]`` counts kernel launches and nothing else.

``plan`` decides the launch from the shapes alone: how many query rows a
block owns and over how many blocks of a cluster each tile's keys are
split. ``tile_keys`` and ``split_keys`` specify which keys a tile, a block
of the cluster and a warp of the block walk, as the kernel computes them
on the card; the CPU tests hold the specification to covering every
visible key exactly once, and ``chip_smoke.py`` holds the kernel to the
plain version at planned splits.

With grad mode on and q, k or v requiring grad, the op is
``FlashAttentionFunction``: its forward is the training kernel
(``csrc/flash_attention_train.cu``, tensor cores, which also writes each
row's log-sum-exp), its backward ``csrc/flash_attention_bwd.cu``; on the
CPU the two plain versions ``flash_attention_train_ref`` and
``flash_attention_bwd_ref``. Only the full sequence (``q_offset == 0``,
``kv_len is None``) takes a gradient, in fp32 or bf16: each dtype has its
own pair of kernels (``flash_attention_train_bf16.cu`` and
``flash_attention_bwd_bf16.cu`` on bf16 tensor cores for bf16), and any
other dtype raises.
``LAUNCHES["flash_attention"]`` counts the serving kernel's and the
training kernel's launches, ``LAUNCHES["flash_attention_bwd"]`` one per
backward call. The fp32 backward is one kernel when the keys fit one tile
of ``bwd_key_tile`` keys, else a D pass, then per round of
``bwd_part_tiles`` key tiles the main kernel and the sum of their partial
dQ; where ``bwd_head_split`` splits a kv group's query heads over blocks,
a last sum of dK and dV. The bf16 backward is two kernels at every length,
``bwd_bf16_plan``'s: a query-tile kernel (D, then dQ from its own sweep)
and a key-tile kernel (dK, dV), and a third, the sum of dK and dV, where
its head split is above 1. The bf16 kernels load their tiles by TMA, which
takes a head of a multiple of 8 from a 16-byte-aligned base: ``tma_ready``
pads or copies what is not so, and the outputs are cut back to hd.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import _build
from .ref import flash_attention_bwd_ref, flash_attention_ref, flash_attention_train_ref

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
# the training kernels' entries by dtype
_TRAIN_ENTRY = {torch.float32: "flash_attention_train_f32",
                torch.bfloat16: "flash_attention_train_bf16"}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32", torch.bfloat16: "flash_attention_bwd_bf16"}
MAX_HEAD_DIM = 256  # two 4-wide chunks of the head a lane in the kernel's p . v
# csrc/flash_attention.cu's constants: the rows a block may own (kR), its
# warps and the blocks of a cluster (the portable limit).
ROW_TILES = (1, 2, 4, 8, 16)
WARPS, MAX_SPLIT = 4, 8
KEYS_PER_SPLIT = 64  # a tile's key range longer than this is split over a cluster
SMS = 132  # an H100's SMs: a launch with this many blocks is not split further
# csrc/flash_attention_bwd.cu: the most scratch one backward call takes for
# the key tiles' partial dQ
BWD_PART_BYTES = 1 << 28
BWD_BLOCKS = 2 * SMS  # blocks a round of the backward aims for before it splits heads
# csrc/flash_attention_bwd_bf16.cu's instances: the head's width (hd rounded
# up to one of them) and, for each, (a) the query rows of a block and the
# keys of its tiles, (b) the keys of a block and the query rows of its
# chunks; up to BF16_SMALL rows and keys (and a head of at most 128),
# BF16_BWD_SMALL's blocks of one warpgroup, two an SM
BF16_BWD_TILES = {64: (192, 64, 192, 32), 80: (192, 64, 192, 32), 96: (192, 64, 128, 32),
                  128: (128, 64, 128, 32), 256: (64, 32, 64, 32)}
BF16_BWD_SMALL = (64, 64, 64, 32)
BF16_SMALL = 64


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    rows: int  # query rows (one position of one head of the group) per block
    tiles: int  # tiles of rows per (batch, kv head)
    split: int  # blocks of a cluster over each tile's keys


def tile_keys(tile: int, rows: int, sq: int, group: int, *, causal: bool, window: int,
              q_offset: int, n_keys: int) -> tuple[int, int]:
    """[lo, hi): the keys any row of ``tile`` can see. Rows are ordered
    position-major, ``group`` heads per position."""
    first = tile * rows
    last = min(first + rows, sq * group) - 1
    lo = max(0, q_offset + first // group - window + 1) if window > 0 else 0
    hi = min(n_keys, q_offset + last // group + 1) if causal else n_keys
    return lo, hi


def split_keys(lo: int, hi: int, parts: int, index: int) -> tuple[int, int]:
    """Part ``index`` of [lo, hi) cut into ``parts`` contiguous ranges of
    ceil(len / parts) keys (the last ones shorter or empty)."""
    per = -(-max(hi - lo, 0) // parts)
    start = min(hi, lo + index * per)
    return start, min(hi, start + per)


def plan(b: int, sq: int, nq: int, nkv: int, *, causal: bool,
         window: int, q_offset: int, n_keys: int) -> FlashPlan:
    """The launch for these shapes: rows a block, the largest of
    ``ROW_TILES`` that divides the call's rows when they are at most 16 (so
    every tile is full), else 16; and a cluster of ceil(keys /
    KEYS_PER_SPLIT) blocks (at most 8) over a tile's keys, the longer of
    the first and the last tile's, when the launch has fewer blocks than
    the card has SMs."""
    group = nq // nkv
    n_rows = sq * group
    rows = ROW_TILES[-1]
    if n_rows <= rows:
        rows = max(r for r in ROW_TILES if n_rows % r == 0)
    tiles = -(-n_rows // rows)
    kw = dict(causal=causal, window=window, q_offset=q_offset, n_keys=n_keys)
    longest = max(hi - lo for lo, hi in (tile_keys(t, rows, sq, group, **kw)
                                         for t in {0, tiles - 1}))
    split = 1
    if b * nkv * tiles < SMS:
        split = max(1, min(MAX_SPLIT, -(-longest // KEYS_PER_SPLIT)))
    return FlashPlan(rows, tiles, split)


def bwd_key_tile(hd: int) -> int:
    """Keys a block of the backward owns: 64 up to hd 128, else 32."""
    return 64 if hd <= 128 else 32


def bwd_part_tiles(b: int, sq: int, skv: int, nq: int, hd: int) -> int:
    """Key tiles whose partial dQ ``(b, sq, nq, hd)`` fp32 each the
    backward's scratch holds at once: 0 when the keys fit one tile (the
    block writes dQ itself), else as many as ``BWD_PART_BYTES`` holds, at
    least 1 and at most every tile (then one round)."""
    tiles = -(-skv // bwd_key_tile(hd))
    if tiles <= 1:
        return 0
    return max(1, min(tiles, BWD_PART_BYTES // (4 * b * sq * nq * hd)))


def bwd_head_split(b: int, sq: int, skv: int, nq: int, nkv: int, hd: int) -> int:
    """Blocks of the backward that share one (key tile, kv head), each
    walking ``group / split`` of its query heads: the smallest divisor of
    the group that gives a round ``BWD_BLOCKS`` blocks, short of one whose
    dK, dV partials (``2 x split x |k|`` fp32, added by a last kernel)
    would pass ``BWD_PART_BYTES``; 1 where the group is 1 or the round
    has blocks enough."""
    group = nq // nkv
    blocks = b * nkv * (bwd_part_tiles(b, sq, skv, nq, hd) or 1)
    kv_bytes = 4 * b * skv * nkv * hd
    best = 1
    for split in range(2, group + 1):
        if blocks * best >= BWD_BLOCKS or 2 * split * kv_bytes > BWD_PART_BYTES:
            break
        if group % split == 0:
            best = split
    return best


@dataclasses.dataclass(frozen=True)
class BwdBf16Plan:
    """The bf16 backward's launches (``csrc/flash_attention_bwd_bf16.cu``)."""
    width: int  # hd padded to a multiple of 8: the head the kernels are given
    head_width: int  # the instance's head width in shared memory
    query_rows: int  # (a) the query-tile kernel: query rows a block
    query_keys: int  # keys a tile of its two sweeps
    query_grid: tuple[int, int]  # (row tiles, b * nq)
    key_keys: int  # (b) the key-tile kernel: keys a block
    key_rows: int  # query rows a chunk
    key_grid: tuple[int, int]  # (b * nkv * head_split, key tiles)
    head_split: int  # blocks of (b) that share a (key tile, kv head)
    dq_scratch_bytes: int  # partial dQ: none
    dkv_scratch_bytes: int  # the head split's fp32 dK, dV parts
    row_scratch_bytes: int  # lse and D for (b), (2, b, nq, sq rounded up to 4) fp32
    launches: int  # kernels a call


def tma_width(hd: int) -> int:
    """hd rounded up to a multiple of 8: a row of bf16 then spans a
    multiple of 16 bytes, as a TMA tensor map's strides must."""
    return -(-hd // 8) * 8


def bwd_bf16_plan(b: int, sq: int, skv: int, nq: int, nkv: int, hd: int) -> BwdBf16Plan:
    """The bf16 backward's launch for these shapes: the instance by the
    padded head, each kernel's tiles and grid, and the head split, the
    smallest divisor of the group that gives the key-tile kernel
    ``BWD_BLOCKS`` blocks, short of one whose fp32 dK, dV parts (``2 x
    split x |k|``) would pass ``BWD_PART_BYTES``; 1 where the group is 1 or
    the blocks are enough. 2 launches, 3 with a split, at every length."""
    width = tma_width(hd)
    head = next(w for w in sorted(BF16_BWD_TILES) if w >= width)
    small = sq <= BF16_SMALL and skv <= BF16_SMALL and head <= 128
    q_rows, q_keys, k_keys, k_rows = BF16_BWD_SMALL if small else BF16_BWD_TILES[head]
    key_tiles = -(-skv // k_keys)
    group = nq // nkv
    blocks = b * nkv * key_tiles
    kv_bytes = 4 * b * skv * nkv * width
    split = 1
    for s in range(2, group + 1):
        if blocks * split >= BWD_BLOCKS or 2 * s * kv_bytes > BWD_PART_BYTES:
            break
        if group % s == 0:
            split = s
    return BwdBf16Plan(
        width=width, head_width=head, query_rows=q_rows, query_keys=q_keys,
        query_grid=(-(-sq // q_rows), b * nq), key_keys=k_keys, key_rows=k_rows,
        key_grid=(b * nkv * split, key_tiles), head_split=split, dq_scratch_bytes=0,
        dkv_scratch_bytes=2 * split * kv_bytes if split > 1 else 0,
        row_scratch_bytes=2 * 4 * b * nq * (-(-sq // 4) * 4), launches=2 + (split > 1))


def tma_ready(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` as the bf16 kernels' TMA loads take it: contiguous, its last
    dimension zero-padded to ``width`` (``tma_width``), from a 16-byte-aligned
    base. ``t`` itself where it already is so, else a fresh tensor (the
    allocators' bases are aligned) with the same values."""
    if t.shape[-1] != width:
        return torch.nn.functional.pad(t, (0, width - t.shape[-1]))
    if not t.is_contiguous() or t.data_ptr() % 16:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _check(q, k, v, q_offset, kv_len) -> None:
    tensors = {"q": q, "k": k, "v": v}
    for name, t in tensors.items():
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (b, s, heads, hd), got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {q.dtype} like q")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    b, _, nq, hd = q.shape
    _, skv, nkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k has shape {tuple(k.shape)}, expected ({b}, skv, nkv, {hd})")
    if v.shape != k.shape:
        raise ValueError(f"v has shape {tuple(v.shape)}, expected {tuple(k.shape)} like k")
    if nkv == 0 or nq % nkv:
        raise ValueError(f"{nq} query heads do not split into groups of {nkv} kv heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} exceeds {MAX_HEAD_DIM}")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be an int >= 0, got {q_offset!r}")
    if kv_len is not None and (not isinstance(kv_len, int) or kv_len < 0):
        raise ValueError(f"kv_len must be None or an int >= 0, got {kv_len!r}")


def _check_every_row_sees_a_key(sq, skv, causal, window, q_offset, kv_len) -> None:
    """Refuse a call that leaves a query row with no visible key: the Pallas
    kernel gives such a row the mean of v (every score at -1e30), which the
    CUDA kernel does not reproduce. A row's count of visible keys, hi - lo,
    is concave in its position, so the first and the last row bound it."""
    n_keys = skv if kv_len is None else min(kv_len, skv)
    for pos in (q_offset, q_offset + sq - 1):
        hi = min(n_keys, pos + 1) if causal else n_keys
        lo = max(0, pos - window + 1) if window > 0 else 0
        if lo >= hi:
            raise ValueError(f"the query row at position {pos} sees no key (kv_len {n_keys}, "
                             f"causal {causal}, window {window})")


def flash_attention_op(q, k, v, *, causal: bool = True, window: int = 0,
                       q_offset: int = 0, kv_len: int | None = None) -> torch.Tensor:
    """Attention of q ``(b, sq, nq, hd)`` over k/v ``(b, skv, nkv, hd)``
    -> a fresh ``(b, sq, nq, hd)`` in q's dtype. Query row ``i`` sits at
    position ``q_offset + i``; only keys before ``kv_len`` (all when None)
    are seen, with the causal and sliding-window masks on top. Every query
    row must see at least one key; ``attend`` never makes a row that does
    not. Differentiable (fp32 or bf16, full sequence) when grad mode is on
    and q, k or v requires grad."""
    _check(q, k, v, q_offset, kv_len)
    if q.shape[1]:
        _check_every_row_sees_a_key(q.shape[1], k.shape[1], causal, window, q_offset, kv_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q_offset != 0 or kv_len is not None:
            raise ValueError("flash_attention_op: a call with q_offset or kv_len (a KV cache) "
                             "takes no gradient; only the full sequence trains")
        if q.dtype not in _TRAIN_ENTRY:
            raise TypeError(f"flash_attention_op: gradients are fp32 or bf16, got {q.dtype}")
        return FlashAttentionFunction.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len)
    return _launch(q, k, v, causal, window, q_offset, kv_len)


def _launch(q, k, v, causal, window, q_offset, kv_len) -> torch.Tensor:
    """Launch ``flash_attention.cu`` on CUDA tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_op: unsupported device {q.device}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention_op: kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_op: {name}'s head_dim must be contiguous")
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    n_keys = skv if kv_len is None else min(kv_len, skv)
    out = torch.empty((b, sq, nq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    launch = plan(b, sq, nq, nkv, causal=causal, window=window, q_offset=q_offset,
                  n_keys=n_keys)
    if launch.tiles > 65535:
        raise ValueError(f"flash_attention_op: {sq} query rows exceed the grid")
    err = getattr(_build.library(), _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv, nq, nkv, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal), window, q_offset,
        n_keys, launch.rows, launch.split, 1.0 / math.sqrt(hd), _build.current_stream(q.device))
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_train(q, k, v, *, causal: bool = True, window: int = 0):
    """The forward of a training step over the full sequence, fp32 or bf16
    -> (out ``(b, sq, nq, hd)`` in q's dtype, lse ``(b, nq, sq)`` fp32):
    ``flash_attention_train.cu`` (fp32) or ``flash_attention_train_bf16.cu``
    on the card (one launch), ``flash_attention_train_ref`` on the CPU."""
    _check(q, k, v, 0, None)
    if q.device.type == "cpu":
        return flash_attention_train_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_train: unsupported device {q.device}")
    if q.dtype not in _TRAIN_ENTRY:
        raise TypeError(f"flash_attention_train: the kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    if b * nq > 65535:
        raise ValueError(f"flash_attention_train: {b} x {nq} heads exceed the grid")
    bf16 = q.dtype == torch.bfloat16  # TMA's loads: a head of a multiple of 8
    width = tma_width(hd) if bf16 else hd
    q, k, v = (tma_ready(t, width) if bf16 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, nq, width), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, nq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out[..., :hd], lse
    err = getattr(_build.library(), _TRAIN_ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, skv,
        nq, nkv, width, int(causal), window, 1.0 / math.sqrt(hd),
        _build.current_stream(q.device))
    _build.check(err, "flash_attention_train")
    LAUNCHES["flash_attention"] += 1
    return (out if width == hd else out[..., :hd].contiguous()), lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0):
    """The backward of ``flash_attention_train``, fp32 or bf16 -> (dq, dk,
    dv) in the shapes and dtype of q, k, v; out and dout in q's dtype, lse
    fp32: ``flash_attention_bwd.cu`` (fp32) or ``flash_attention_bwd_bf16.cu``
    on the card (one call of its entry), ``flash_attention_bwd_ref`` on the
    CPU. The bf16 versions compute D from P and dP and do not read out,
    which may then be None."""
    _check(q, k, v, 0, None)
    b, sq, nq, hd = q.shape
    if q.dtype == torch.bfloat16:
        out = None
    elif out is None:
        raise ValueError(f"flash_attention_bwd: {q.dtype} needs out")
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype),
                                  ("dout", dout, q.shape, q.dtype),
                                  ("lse", lse, (b, nq, sq), torch.float32)):
        if t is None:
            continue
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected {dtype} {tuple(shape)} on {q.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    if q.dtype not in _BWD_ENTRY:
        raise TypeError(f"flash_attention_bwd: the kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    skv, nkv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        return _bwd_bf16(q, k, v, lse, dout, causal, window)
    if b * nkv > 2**31 - 1 or -(-skv // 32) > 65535:
        raise ValueError(f"flash_attention_bwd: {b} x {nkv} kv heads or {skv} keys exceed the "
                         f"grid")
    q, k, v, out, lse, dout = (t.contiguous() for t in (q, k, v, out, lse, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, nq, sq), dtype=torch.float32, device=q.device)
    slots = bwd_part_tiles(b, sq, skv, nq, hd)
    split = bwd_head_split(b, sq, skv, nq, nkv, hd)
    part = torch.empty((slots, b, sq, nq, hd), dtype=torch.float32, device=q.device) \
        if slots else None
    kv_part = torch.empty((2, split, *k.shape), dtype=torch.float32, device=q.device) \
        if split > 1 else None
    err = getattr(_build.library(), _BWD_ENTRY[q.dtype])(
        *(t.data_ptr() for t in (q, k, v, out, dout)), lse.data_ptr(), delta.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (part, kv_part)), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, skv, nq, nkv, hd, int(causal), window, slots, split,
        1.0 / math.sqrt(hd), _build.current_stream(q.device))
    _build.check(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def bwd_bf16_kernels() -> int:
    """The kernels ``flash_attention_bwd_bf16.cu`` has launched in this
    process, as its library counts them: read around a call, its kernels."""
    return _build.library().flash_attention_bwd_bf16_kernels()


def _bwd_bf16(q, k, v, lse, dout, causal, window):
    """``flash_attention_bwd_bf16.cu`` on CUDA tensors, as ``bwd_bf16_plan``
    lays it out: the head padded to ``tma_width``, the gradients cut back."""
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    launch = bwd_bf16_plan(b, sq, skv, nq, nkv, hd)
    if b * nq > 65535 or launch.key_grid[1] > 65535 or launch.key_grid[0] > 2**31 - 1:
        raise ValueError(f"flash_attention_bwd: {b} x {nq} heads, {b} x {nkv} kv heads or "
                         f"{skv} keys exceed the grid")
    width = launch.width
    q, k, v, dout = (tma_ready(t, width) for t in (q, k, v, dout))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return tuple(t[..., :hd].zero_() for t in (dq, dk, dv))
    rows = torch.empty(launch.row_scratch_bytes // 4, dtype=torch.float32, device=q.device)
    kv_part = torch.empty(launch.dkv_scratch_bytes // 4, dtype=torch.float32, device=q.device) \
        if launch.head_split > 1 else None
    err = _build.library().flash_attention_bwd_bf16(
        *(t.data_ptr() for t in (q, k, v, dout, lse, rows)),
        None if kv_part is None else kv_part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, sq, skv, nq, nkv, width, int(causal), window, launch.head_split,
        1.0 / math.sqrt(hd), _build.current_stream(q.device))
    _build.check(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    if width == hd:
        return dq, dk, dv
    return tuple(t[..., :hd].contiguous() for t in (dq, dk, dv))

class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention_op`` over the full sequence with a gradient, fp32
    or bf16: the training forward saves q, k and v in their dtype, each
    row's log-sum-exp in fp32 and, in fp32, out (the bf16 backward does not
    read it); the backward recomputes the probabilities from them. The
    incoming gradient is taken in out's dtype, as autograd gives it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_train(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, lse, *(() if q.dtype == torch.bfloat16 else (out,)))
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, *out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out[0] if out else None, lse, dout,
                                         causal=ctx.causal, window=ctx.window)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None, dv if need[2] else None,
                None, None)

"""Plain PyTorch twin of the byte kernels' work split (``csrc/byte_scan.cuh``).

``text_clean.cu`` and ``text_scan.cu`` split a flat buffer of N bytes by
bytes, not by rows: block ``b`` of ``G`` takes the rows that start in
``[b * N // G, (b + 1) * N // G)``, so every block begins at a row start
and no running sum crosses a block. Each block walks its range in tiles
that start at its first byte rounded down to ``WORD``; the row starts in a
tile restart the sum, and a carry takes it from tile to tile. A tile is
256 threads' bytes: 32 a thread in ``text_clean.cu`` (``CLEAN_TILE``), 16
in ``text_scan.cu`` (``SCAN_TILE``).

This module walks a buffer block by block and tile by tile exactly so,
with the same split rule, tile size, row-start flags and carry, and
returns the bytes and the split. Nothing on the card's path calls it: it
holds the decomposition against the plain versions in ``ref.py`` and the
JAX kernels on the CPU. ``layouts`` builds the row layouts that stress the
split; ``chip_smoke.py`` runs the kernels on them too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

THREADS = 256
WORD = 16  # a tile starts at a block's first byte rounded down to WORD
CLEAN_TILE = THREADS * 32
SCAN_TILE = THREADS * 16
BLOCKS_PER_SM = 4
SMS = 132  # multiprocessors of an H100 SXM


class Split(NamedTuple):
    """Block ``b`` covers bytes ``[starts[b], starts[b + 1])`` and rows
    ``[rows[b], rows[b + 1])``."""
    starts: torch.Tensor
    rows: torch.Tensor


def grid_blocks(n_rows: int, sms: int = SMS) -> int:
    """The kernels' launch: ``BLOCKS_PER_SM`` a multiprocessor, at most one a row."""
    return min(n_rows, BLOCKS_PER_SM * sms)


def row_starts(offsets, n_rows: int, width: int) -> torch.Tensor:
    """int64 ``(n_rows + 1,)`` row bounds: ``offsets``, or multiples of
    ``width`` for the matrix form (``offsets`` None)."""
    if offsets is None:
        return torch.arange(n_rows + 1, dtype=torch.int64) * width
    return offsets.to(torch.int64).cpu()


def split(offsets, blocks: int, *, n_rows: int | None = None, width: int = 0) -> Split:
    """The blocks' ranges: for each bound ``t = b * N // blocks`` the first
    row whose start is ``>= t`` (``offsets`` None: rows of ``width``)."""
    if n_rows is None:
        n_rows = offsets.numel() - 1
    bounds = row_starts(offsets, n_rows, width)
    n = int(bounds[-1])
    t = torch.arange(blocks + 1, dtype=torch.int64) * n // blocks
    rows = torch.searchsorted(bounds, t, side="left")
    return Split(bounds[rows], rows)


def _segmented(delta: torch.Tensor, flag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive running sums of ``delta`` along the last dimension that
    restart at each ``flag``, from 0; and where a flag was seen so far."""
    total = torch.cumsum(delta, -1)
    idx = torch.arange(delta.shape[-1]).expand_as(delta)
    last = torch.cummax(torch.where(flag, idx, -1), -1).values
    before = torch.cat([torch.zeros_like(total[..., :1]), total], -1)
    before = torch.gather(before, -1, last.clamp(min=0))
    return torch.where(last >= 0, total - before, total), last >= 0


class _Tiles(NamedTuple):
    pos: torch.Tensor     # (tiles, tile) byte positions
    inside: torch.Tensor  # (tiles, tile) inside the tile's block's range
    x: torch.Tensor       # (tiles, tile) int64 bytes, 0 outside the range
    flag: torch.Tensor    # (tiles, tile) a row starts here
    first: torch.Tensor   # (tiles,) the first tile of its block


def _tiles(buf, bounds: torch.Tensor, sp: Split, tile: int) -> _Tiles:
    """Every tile of every non-empty block, in order: a block's tiles start
    at its first byte rounded down to ``WORD`` and step by ``tile``."""
    begin, end = sp.starts[:-1], sp.starts[1:]
    live = torch.nonzero(begin < end).flatten()
    lo = begin[live] - begin[live] % WORD
    n_tiles = (end[live] - lo + tile - 1) // tile
    block = torch.repeat_interleave(live, n_tiles)
    k = torch.arange(int(n_tiles.sum())) - torch.repeat_interleave(
        torch.cumsum(n_tiles, 0) - n_tiles, n_tiles)
    base = lo[torch.searchsorted(live, block)] + k * tile
    pos = base[:, None] + torch.arange(tile)
    inside = (pos >= begin[block][:, None]) & (pos < end[block][:, None])
    x = torch.zeros(pos.shape, dtype=torch.int64)
    x[inside] = buf[pos[inside]].to(torch.int64)
    # each row start goes to the tile of the block whose rows hold it
    rows = torch.arange(bounds.numel() - 1)
    owner = torch.searchsorted(sp.rows, rows, side="right") - 1
    rows, owner = rows[owner < begin.numel()], owner[owner < begin.numel()]  # not empty rows at N
    tile_of_block = torch.full((begin.numel(),), -1, dtype=torch.int64)
    tile_of_block[live] = torch.cumsum(n_tiles, 0) - n_tiles
    at = bounds[rows] - (begin[owner] - begin[owner] % WORD)
    keep = tile_of_block[owner] >= 0
    flag = torch.zeros(pos.shape, dtype=torch.bool)
    flag[tile_of_block[owner][keep] + at[keep] // tile, at[keep] % tile] = True
    return _Tiles(pos, inside, x, flag, k == 0)


def _depth(delta: torch.Tensor, t: _Tiles) -> torch.Tensor:
    """The running sum per row: a segmented scan inside each tile, then the
    carry from tile to tile of a block (0 at a block's first tile)."""
    local, seen = _segmented(delta, t.flag)
    ends, _ = _segmented(local[:, -1], t.flag.any(1) | t.first)
    carry = torch.where(t.first, 0, torch.roll(ends, 1))
    return torch.where(seen, local, carry[:, None] + local)


def _lower(x: torch.Tensor) -> torch.Tensor:
    return torch.where((x >= 65) & (x <= 90), x + 32, x)


def _walk(buf, offsets, blocks, n_rows, width, tile, tile_fn) -> tuple[torch.Tensor, Split]:
    """Run ``tile_fn(x, tiles) -> out`` over all tiles of all blocks at once
    and put the bytes inside the blocks' ranges back in place."""
    buf = buf.cpu()
    bounds = row_starts(offsets, n_rows, width)
    sp = split(offsets, blocks, n_rows=n_rows, width=width)
    out = torch.empty_like(buf)
    if buf.numel():
        t = _tiles(buf, bounds, sp, tile)
        out[t.pos[t.inside]] = tile_fn(t.x, t)[t.inside].to(torch.uint8)
    return out, sp


def _clean_tile(strip_html: bool):
    def tile(x, t):
        x = _lower(x)
        keep = (x >= 97) & (x <= 122)
        if strip_html:
            keep &= (_depth((x == 60).long() - (x == 62).long(), t) == 0) & (x != 62)
        return torch.where(keep, x, 32)
    return tile


def _scan_tile(lower: bool, strip_html: bool, strip_parens: bool):
    def tile(x, t):
        if lower:
            x = _lower(x)
        alive = torch.ones_like(x, dtype=torch.bool)
        if strip_html:
            alive = (_depth((x == 60).long() - (x == 62).long(), t) <= 0) & (x != 62)
        if strip_parens:
            opens, closes = (x == 40) & alive, (x == 41) & alive
            alive &= (_depth(opens.long() - closes.long(), t) <= 0) & ~closes
        return torch.where(alive, x, 0)
    return tile


def text_clean_tiles(buf, offsets, *, strip_html: bool = True, blocks: int | None = None,
                     width: int = 0) -> tuple[torch.Tensor, Split]:
    """``text_clean.cu`` over a flat uint8 buffer by ``offsets`` (or, with
    ``offsets`` None, rows of ``width`` bytes), walked as the kernel walks
    it with ``blocks`` blocks (default: the kernel's launch on an H100).
    Returns the cleaned bytes and the split."""
    n_rows = buf.numel() // width if offsets is None else offsets.numel() - 1
    blocks = grid_blocks(n_rows) if blocks is None else blocks
    return _walk(buf, offsets, blocks, n_rows, width, CLEAN_TILE, _clean_tile(strip_html))


def text_scan_tiles(buf, offsets, *, lower: bool = True, strip_html: bool = False,
                    strip_parens: bool = False, blocks: int | None = None
                    ) -> tuple[torch.Tensor, Split]:
    """``text_scan.cu`` over a flat uint8 buffer by ``offsets``, walked as
    the kernel walks it. Returns the scanned bytes and the split."""
    n_rows = offsets.numel() - 1
    blocks = grid_blocks(n_rows) if blocks is None else blocks
    return _walk(buf, offsets, blocks, n_rows, 0, SCAN_TILE,
                 _scan_tile(lower, strip_html, strip_parens))


def layouts(seed: int = 0) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Row layouts chosen against the split: name -> (uint8 buffer, int64
    offsets). Bytes are drawn from the seed, rich in ``<``, ``>``, ``(``,
    ``)``, NUL, upper case and bytes above 127."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"<<>>(()aAzZ \x00\xff\xc3.", dtype=np.uint8)

    def noise(n):
        out = rng.integers(0, 256, n, dtype=np.uint8)
        pick = rng.random(n) < 0.8
        out[pick] = alphabet[rng.integers(0, alphabet.size, int(pick.sum()))]
        return out

    def rows(lens, fill=None):
        lens = np.asarray(lens, dtype=np.int64)
        buf = noise(int(lens.sum())) if fill is None else fill
        return buf, np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    # one row of many tiles: a '<' in its first tile, the '>' several tiles later
    long = bytearray(b"Head <" + b"Span " * (6 * CLEAN_TILE // 5) + b"> Tail words " * 40)
    long_lens = [37, len(long), 11]
    long_buf = np.concatenate([noise(37), np.frombuffer(bytes(long), np.uint8), noise(11)])
    return {
        # rows start on the first byte of a scan tile and of a clean tile
        "row_on_tile_boundary": rows([SCAN_TILE, 10, SCAN_TILE - 10, CLEAN_TILE - 2 * SCAN_TILE,
                                      50, CLEAN_TILE + 3]),
        # 4 rows, 4 blocks: the bounds 1,000 and 2,000 are row starts
        "row_on_block_split": rows([1000, 1000, 1500, 500]),
        "row_of_many_tiles": rows(long_lens, long_buf),
        "empty_rows_in_one_tile": rows([5] + [0] * 300 + [7] + [0] * 200 + [3000, 0]),
        "all_rows_empty": rows([0] * 50),
        "one_byte_rows": rows([1] * 1500),
        "fewer_than_16_bytes": rows([2, 3, 0, 4, 1]),
        "ragged_300_rows": rows(rng.integers(0, 5001, 300)),
    }

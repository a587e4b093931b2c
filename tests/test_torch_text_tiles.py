"""The byte kernels' work split (``repro_torch.kernels.text_clean.tiles``),
on the CPU.

``text_clean.cu`` and ``text_scan.cu`` split a flat buffer by bytes at row
starts and walk each block's share in tiles (8,192 and 4,096 bytes) with a
carry. The twin in ``tiles.py`` walks a buffer the same way; here it is held byte for
byte against the plain versions (``ref.py``) at layouts chosen against the
split (``tiles.layouts``: rows on a tile boundary and on a block split, a
row of many tiles, hundreds of empty rows in one tile, an all-empty column,
1-byte rows, fewer than 16 bytes, 300 seeded ragged rows), at the kernels'
own block count and at others (more blocks than rows among them), with and
without ``strip_html`` and for all 8 scan flag sets; and on the matrix form
against the JAX kernels in interpret mode. The split's invariants are
checked on every layout. ``chip_smoke.py`` runs the kernels themselves on
the same layouts on the card."""

import itertools

import numpy as np
import pytest
import torch

from repro.kernels.text_clean.ops import text_clean_op as jax_text_clean_op
from repro.kernels.text_clean.ops import text_scan_op as jax_text_scan_op
from repro_torch.kernels.text_clean import tiles
from repro_torch.kernels.text_clean.ref import (text_clean_flat_ref, text_clean_ref,
                                                text_scan_ref)

LAYOUTS = tiles.layouts(0)
NAMES = sorted(LAYOUTS)
FLAGS = [dict(lower=lo, strip_html=sh, strip_parens=sp)
         for lo, sh, sp in itertools.product([False, True], repeat=3)]
FLAG_IDS = ["lower%d-html%d-parens%d" % tuple(f.values()) for f in FLAGS]


def layout(name):
    buf, offsets = LAYOUTS[name]
    return torch.from_numpy(buf.copy()), torch.from_numpy(offsets.copy())


def block_counts(n_rows):
    """The kernels' launch on an H100, one block, three, and more blocks
    than rows."""
    return {"kernel": tiles.grid_blocks(n_rows), "one": 1, "three": 3,
            "more_than_rows": n_rows + 7}


@pytest.mark.parametrize("blocks", ["kernel", "one", "three", "more_than_rows"])
@pytest.mark.parametrize("strip_html", [True, False], ids=["html", "nohtml"])
@pytest.mark.parametrize("name", NAMES)
def test_clean_twin_matches_the_plain_version(name, strip_html, blocks):
    buf, offsets = layout(name)
    g = block_counts(offsets.numel() - 1)[blocks]
    got, sp = tiles.text_clean_tiles(buf, offsets, strip_html=strip_html, blocks=g)
    assert sp.starts.numel() == g + 1
    assert torch.equal(got, text_clean_flat_ref(buf, offsets, strip_html=strip_html))


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("name", NAMES)
def test_scan_twin_matches_the_plain_version(name, flags):
    buf, offsets = layout(name)
    got, _ = tiles.text_scan_tiles(buf, offsets, **flags)
    assert torch.equal(got, text_scan_ref(buf, offsets, **flags))


@pytest.mark.parametrize("blocks", ["one", "three", "more_than_rows"])
@pytest.mark.parametrize("name", NAMES)
def test_scan_twin_at_other_block_counts(name, blocks):
    buf, offsets = layout(name)
    g = block_counts(offsets.numel() - 1)[blocks]
    for flags in FLAGS:
        got, _ = tiles.text_scan_tiles(buf, offsets, blocks=g, **flags)
        assert torch.equal(got, text_scan_ref(buf, offsets, **flags)), flags


@pytest.mark.parametrize("blocks", ["kernel", "one", "three", "more_than_rows"])
@pytest.mark.parametrize("name", NAMES)
def test_split_invariants(name, blocks):
    """Every block starts at a row start (0 among them), the blocks cover
    [0, N) once and in order, and a block is empty exactly when no row
    starts in its share of the bytes; so none is empty where no row is
    longer than a share."""
    _, offsets = layout(name)
    n_rows, n = offsets.numel() - 1, int(offsets[-1])
    g = block_counts(n_rows)[blocks]
    sp = tiles.split(offsets, g)
    starts, rows = sp.starts.tolist(), sp.rows.tolist()
    assert starts[0] == 0 and starts[-1] == n
    assert all(a <= b for a, b in zip(starts, starts[1:]))
    assert all(a <= b for a, b in zip(rows, rows[1:]))
    assert rows[0] == 0 and all(0 <= r <= n_rows for r in rows)
    assert all(int(offsets[r]) == s for r, s in zip(rows, starts))
    bounds = [b * n // g for b in range(g + 1)]
    row_at = offsets.tolist()
    for b in range(g):
        has_start = any(bounds[b] <= v < bounds[b + 1] for v in row_at)
        assert (starts[b] < starts[b + 1]) == has_start, b
    lens = offsets[1:] - offsets[:-1]
    if n and int(lens.max()) <= n // g:
        assert all(a < b for a, b in zip(starts, starts[1:]))


def test_layouts_reach_what_they_are_named_for():
    tile = tiles.SCAN_TILE
    starts = LAYOUTS["row_on_tile_boundary"][1]
    assert tile in starts and tiles.CLEAN_TILE in starts
    _, offsets = layout("row_on_block_split")
    g = tiles.grid_blocks(offsets.numel() - 1)
    n = int(offsets[-1])
    assert sum(b * n // g in offsets.tolist() for b in range(1, g)) >= 2
    buf, offsets = LAYOUTS["row_of_many_tiles"]
    row = buf[offsets[1]:offsets[2]].tobytes()
    clean = tiles.CLEAN_TILE
    assert row.index(b"<") + offsets[1] < clean and row.index(b">") + offsets[1] > 5 * clean
    assert int(np.diff(offsets).max()) > 5 * tile
    empty = np.diff(LAYOUTS["empty_rows_in_one_tile"][1]) == 0
    assert empty.sum() >= 500 and LAYOUTS["empty_rows_in_one_tile"][1][-1] < tile
    assert LAYOUTS["all_rows_empty"][0].size == 0
    assert set(np.diff(LAYOUTS["one_byte_rows"][1]).tolist()) == {1}
    assert LAYOUTS["fewer_than_16_bytes"][0].size < 16
    lens = np.diff(LAYOUTS["ragged_300_rows"][1])
    assert lens.size == 300 and lens.max() <= 5000


MATRICES = [(9, 1), (16, 37), (12, 300), (4, 4097), (3, 5000)]


def random_matrix(seed, n, width):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"<<>>(()aAzZ \x00\xff\xc3.", dtype=np.uint8)
    return alphabet[rng.integers(0, alphabet.size, (n, width))]


@pytest.mark.parametrize("strip_html", [True, False], ids=["html", "nohtml"])
@pytest.mark.parametrize("shape", MATRICES, ids=[f"{n}x{w}" for n, w in MATRICES])
def test_clean_twin_on_the_matrix_form_matches_jax(shape, strip_html):
    n, width = shape
    mat = random_matrix(width, n, width)
    flat = torch.from_numpy(mat.reshape(-1).copy())
    want = np.asarray(jax_text_clean_op(mat, strip_html=strip_html, blk_rows=8, interpret=True))
    assert np.array_equal(text_clean_ref(torch.from_numpy(mat), strip_html=strip_html).numpy(),
                          want)
    for blocks in (tiles.grid_blocks(n), 2, n + 3):
        got, sp = tiles.text_clean_tiles(flat, None, strip_html=strip_html, blocks=blocks,
                                         width=width)
        assert np.array_equal(got.numpy().reshape(n, width), want), blocks
        assert all(int(s) % width == 0 for s in sp.starts)


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
def test_scan_twin_on_the_matrix_form_matches_jax(flags):
    n, width = 12, 300
    mat = random_matrix(1, n, width)
    flat = torch.from_numpy(mat.reshape(-1).copy())
    offsets = torch.arange(n + 1, dtype=torch.int64) * width
    want = np.asarray(jax_text_scan_op(mat, blk_rows=8, interpret=True, **flags))
    for blocks in (tiles.grid_blocks(n), 5):
        got, _ = tiles.text_scan_tiles(flat, offsets, blocks=blocks, **flags)
        assert np.array_equal(got.numpy().reshape(n, width), want), blocks

"""The bf16 flash backward's launch plan and the TMA-readiness helper, on
the CPU with nothing built.

``bwd_bf16_plan`` (``repro_torch/kernels/flash_attention/ops.py``) says
how ``csrc/flash_attention_bwd_bf16.cu`` launches: the query-tile kernel
(D, then dQ) and the key-tile kernel (dK, dV), their tiles and grids, the
head split and its scratch, no partial-dQ scratch, and 2 launches a call,
3 with a head split, at every sequence length. Its tiles are held to the
instances the source dispatches to. ``tma_ready`` pads the head to a
multiple of 8 and copies a misaligned or strided tensor, values unchanged.
"""

import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.flash_attention import ops

SOURCE = Path(ops.__file__).resolve().parents[1] / "csrc" / "flash_attention_bwd_bf16.cu"

# (b, s, nq, nkv, hd): StableLM-3B's train_4k microbatch and shorter, the
# MQA RecurrentGemma-9B, HuBERT X-Large, Qwen2-VL-72B's groups of 8,
# DeepSeek-MoE-16B, and ragged lengths and heads
SHAPES = [(8, 4096, 32, 32, 80), (8, 2048, 32, 32, 80), (8, 512, 32, 32, 80),
          (8, 64, 32, 32, 80), (2, 2048, 16, 1, 256), (2, 64, 16, 1, 256),
          (8, 512, 16, 16, 80), (2, 64, 64, 8, 128), (2, 64, 16, 16, 128),
          (1, 1, 32, 32, 80), (2, 200, 8, 2, 80), (1, 129, 16, 1, 256),
          (2, 513, 32, 32, 80), (1, 100, 4, 1, 36), (3, 63, 16, 1, 256), (1, 300, 2, 2, 256)]


def dispatched_tiles() -> dict[int, list[tuple[int, int, int, int]]]:
    """The source's instances by head width, in dispatch order (the short
    sequences' first where there are two): (query rows a block of the
    query-tile kernel, keys a tile of its sweeps, keys a block of the
    key-tile kernel, query rows a chunk), read from its dispatch."""
    calls = re.findall(r"launch_as<(\d+), \d+, (\d+), (\d+), (\d+), (\d+), (true|false)>",
                       SOURCE.read_text())
    tiles: dict[int, list[tuple[int, int, int, int]]] = {}
    for w, bc, wg, br, wgb, split in calls:
        keys = 64 if split == "true" else 64 * int(wgb)
        tiles.setdefault(int(w), []).append((64 * int(wg), int(bc), keys, int(br)))
    return tiles


def test_tiles_are_the_sources():
    dispatched = dispatched_tiles()
    assert set(dispatched) == set(ops.BF16_BWD_TILES)
    for width, tiles in dispatched.items():
        if width <= 128:  # short sequences, then the rest
            assert tiles == [ops.BF16_BWD_SMALL, ops.BF16_BWD_TILES[width]]
        else:
            assert tiles == [ops.BF16_BWD_TILES[width]]


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_launches_two_kernels_and_no_partial_dq(shape):
    b, s, nq, nkv, hd = shape
    plan = ops.bwd_bf16_plan(b, s, s, nq, nkv, hd)
    assert plan.width == ops.tma_width(hd) and plan.width % 8 == 0 and plan.width >= hd
    assert plan.head_width >= plan.width and plan.head_width in ops.BF16_BWD_TILES
    assert plan.dq_scratch_bytes == 0
    assert plan.launches == (3 if plan.head_split > 1 else 2)
    # the grids cover every query row and every key exactly once
    rows, heads = plan.query_grid
    assert heads == b * nq and (rows - 1) * plan.query_rows < s <= rows * plan.query_rows
    kv_blocks, key_tiles = plan.key_grid
    assert kv_blocks == b * nkv * plan.head_split
    assert (key_tiles - 1) * plan.key_keys < s <= key_tiles * plan.key_keys
    # the split divides the group, and its parts fit the scratch limit
    assert (nq // nkv) % plan.head_split == 0
    assert plan.dkv_scratch_bytes == (2 * plan.head_split * 4 * b * s * nkv * plan.width
                                      if plan.head_split > 1 else 0)
    assert plan.dkv_scratch_bytes <= ops.BWD_PART_BYTES
    assert plan.row_scratch_bytes == 2 * 4 * b * nq * (-(-s // 4) * 4)


@pytest.mark.parametrize("shape", SHAPES)
def test_head_split_is_the_smallest_that_fills_the_card(shape):
    b, s, nq, nkv, hd = shape
    plan = ops.bwd_bf16_plan(b, s, s, nq, nkv, hd)
    blocks = b * nkv * plan.key_grid[1]
    group = nq // nkv
    if plan.head_split > 1:  # no smaller divisor fills the card
        smaller = [d for d in range(1, plan.head_split) if group % d == 0]
        assert all(blocks * d < ops.BWD_BLOCKS for d in smaller)
    else:  # one block a (key tile, kv head) fills it, or no split can
        fits = [d for d in range(2, group + 1) if group % d == 0
                and 2 * d * 4 * b * s * nkv * plan.width <= ops.BWD_PART_BYTES]
        assert blocks >= ops.BWD_BLOCKS or not fits or group == 1


def test_plan_at_the_main_path_shapes():
    train_4k = ops.bwd_bf16_plan(8, 4096, 4096, 32, 32, 80)
    assert (train_4k.head_width, train_4k.query_grid, train_4k.key_grid) == \
        (80, (22, 256), (256, 22))
    assert (train_4k.head_split, train_4k.launches, train_4k.dkv_scratch_bytes) == (1, 2, 0)
    mqa = ops.bwd_bf16_plan(2, 2048, 2048, 16, 1, 256)  # RecurrentGemma-9B: 64 blocks unsplit
    assert (mqa.head_width, mqa.key_keys, mqa.key_rows) == (256, 64, 32)
    assert (mqa.head_split, mqa.key_grid, mqa.launches) == (8, (16, 32), 3)
    short = ops.bwd_bf16_plan(8, 64, 64, 32, 32, 80)  # one warpgroup a block, two an SM
    assert (short.query_rows, short.key_keys, short.query_grid, short.key_grid) == \
        (64, 64, (1, 256), (256, 1))


@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 1000, 4096, 16384])
def test_launches_do_not_grow_with_the_sequence(s):
    for b, nq, nkv, hd in [(8, 32, 32, 80), (2, 16, 1, 256), (2, 64, 8, 128)]:
        assert ops.bwd_bf16_plan(b, s, s, nq, nkv, hd).launches in (2, 3)


@pytest.mark.parametrize("hd, width", [(1, 8), (8, 8), (36, 40), (64, 64), (72, 72), (80, 80),
                                       (100, 104), (255, 256), (256, 256)])
def test_tma_width(hd, width):
    assert ops.tma_width(hd) == width


def test_tma_ready_keeps_a_ready_tensor():
    t = torch.randn(2, 5, 3, 16).bfloat16()
    assert ops.tma_ready(t, 16) is t


def test_tma_ready_pads_the_head_with_zeros():
    t = torch.randn(2, 7, 3, 36, generator=torch.Generator().manual_seed(0)).bfloat16()
    got = ops.tma_ready(t, ops.tma_width(36))
    assert got.shape == (2, 7, 3, 40) and got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got[..., :36], t) and not got[..., 36:].any()


def test_tma_ready_copies_a_view_at_an_odd_offset():
    flat = torch.randn(1 + 2 * 9 * 4 * 64, generator=torch.Generator().manual_seed(1)).bfloat16()
    t = flat[1:].view(2, 9, 4, 64)  # contiguous, 2 bytes past an aligned base
    assert t.is_contiguous() and t.data_ptr() % 16 == 2
    got = ops.tma_ready(t, 64)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, t)
    assert got.data_ptr() != t.data_ptr()


def test_tma_ready_copies_a_strided_view():
    t = torch.randn(2, 4, 9, 64).bfloat16().transpose(1, 2)  # (2, 9, 4, 64), heads outer
    got = ops.tma_ready(t, 64)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0 and torch.equal(got, t)

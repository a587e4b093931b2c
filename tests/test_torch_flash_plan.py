"""The flash-attention kernel's launch plan (``repro_torch.kernels.
flash_attention.ops.plan``) and its key split, on the CPU.

The CUDA kernel gives each block a tile of query rows of one kv head and
splits the tile's keys over the blocks of a cluster and each block's share
over its warps. ``tile_keys`` and ``split_keys`` are the specification of
that split, which the kernel computes on the card (``chip_smoke.py`` holds
the kernel itself to the plain version at these shapes). For every shape
that ``chip_smoke.py`` runs, at the plan's split and at other cluster
sizes, every key a row can see must fall in its tile's range, and the
blocks' and warps' ranges must cover that range exactly once; the plan must
stay within the cluster and grid limits and split the shapes listed for
splitting, some of which must leave a block's range empty or wholly masked
for a row."""

import importlib.util
from pathlib import Path

import pytest

from repro_torch.kernels.flash_attention import ops

ROOT = Path(__file__).resolve().parents[1]


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = load_smoke()
# (b, sq, skv, nq, nkv, hd, causal, window, q_offset, kv_len)
CASES = SMOKE.FLASH_SERVED + SMOKE.FLASH_EDGES + SMOKE.FLASH_SPLITS


def visible(pos: int, key: int, causal, window, n_keys) -> bool:
    return key < n_keys and (not causal or key <= pos) and (window <= 0 or key > pos - window)


def case_plan(case):
    b, sq, skv, nq, nkv, hd, causal, window, q_offset, kv_len = case
    n_keys = skv if kv_len is None else min(kv_len, skv)
    kw = dict(causal=causal, window=window, q_offset=q_offset, n_keys=n_keys)
    return ops.plan(b, sq, nq, nkv, **kw), kw


def warp_ranges(lo, hi, split):
    """{(rank, warp): [lo, hi)} of one tile, as the kernel walks it."""
    out = {}
    for rank in range(split):
        b_lo, b_hi = ops.split_keys(lo, hi, split, rank)
        for warp in range(ops.WARPS):
            out[rank, warp] = ops.split_keys(b_lo, b_hi, ops.WARPS, warp)
    return out


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
@pytest.mark.parametrize("split", [None, 1, 3, ops.MAX_SPLIT])
def test_plan_covers_every_visible_key_once(case, split):
    """At the plan's split (None) and at other cluster sizes."""
    b, sq, skv, nq, nkv, hd, causal, window, q_offset, kv_len = case
    plan, kw = case_plan(case)
    group = nq // nkv
    assert plan.rows in ops.ROW_TILES and 1 <= plan.split <= ops.MAX_SPLIT
    assert plan.rows * (plan.tiles - 1) < sq * group <= plan.rows * plan.tiles <= 65535 * plan.rows
    split = plan.split if split is None else split
    for tile in range(plan.tiles):
        lo, hi = ops.tile_keys(tile, plan.rows, sq, group, **kw)
        for row in range(tile * plan.rows, min((tile + 1) * plan.rows, sq * group)):
            seen = [t for t in range(kw["n_keys"])
                    if visible(q_offset + row // group, t, causal, window, kw["n_keys"])]
            assert seen and lo <= seen[0] and seen[-1] < hi, (tile, row)
        covered = [t for a, z in warp_ranges(lo, hi, split).values() for t in range(a, z)]
        assert sorted(covered) == list(range(lo, hi)), tile


def masked_and_empty(case) -> tuple[bool, bool]:
    """Whether some block's key range is wholly masked for a row it serves,
    and whether some block's range is empty, at the case's plan."""
    b, sq, skv, nq, nkv, hd, causal, window, q_offset, kv_len = case
    plan, kw = case_plan(case)
    group = nq // nkv
    masked = empty = False
    for tile in range(plan.tiles):
        lo, hi = ops.tile_keys(tile, plan.rows, sq, group, **kw)
        for rank in range(plan.split):
            a, z = ops.split_keys(lo, hi, plan.split, rank)
            empty |= a == z
            for row in range(tile * plan.rows, min((tile + 1) * plan.rows, sq * group)):
                pos = q_offset + row // group
                masked |= a < z and not any(visible(pos, t, causal, window, kw["n_keys"])
                                            for t in range(a, z))
    return masked, empty


@pytest.mark.parametrize("name", ["masked", "empty"])
def test_smoke_split_cases_reach_the_traps(name):
    """chip_smoke.py's split shapes include, at the plan's own split, a
    block range wholly masked for some row and an empty one, so the card
    meets both in the combine."""
    hits = [masked_and_empty(c) for c in SMOKE.FLASH_SPLITS]
    assert any(h[0] if name == "masked" else h[1] for h in hits)


def test_plan_splits_long_caches_and_not_short_steps():
    for case in SMOKE.FLASH_SERVED:
        b, sq, skv, nq, nkv, hd, causal, window, q_offset, kv_len = case
        plan, _ = case_plan(case)
        assert plan.split == (1 if kv_len <= ops.KEYS_PER_SPLIT else 2)
        assert plan.tiles == -(-sq * nq // nkv // plan.rows)
        n_rows = sq * nq // nkv
        assert n_rows % plan.rows == 0  # full tiles
        assert plan.rows == max(r for r in ops.ROW_TILES if n_rows % r == 0)
    assert all(case_plan(c)[0].split > 1 for c in SMOKE.FLASH_SPLITS)
    long = [c for c in SMOKE.FLASH_SPLITS if c[9] > 1024]
    assert {c[5] for c in long} >= {80, 256}
    assert all(case_plan(c)[0].split == ops.MAX_SPLIT for c in long)

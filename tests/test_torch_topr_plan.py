"""The launch plan of the placement kernel (``placement/device.py::topr_plan``)
on the CPU: what ``csrc/placement_topr.cu`` is told to do must cover every
(row, column) pair exactly once, keep its clusters and shared memory within
the card's limits, and reach the card's 132 SMs wherever the rows and the
column slices allow. The kernel itself runs only on the card
(tests/test_torch_cuda.py); this holds the host half under hypothesis.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rapid_tpu_torch.placement import device as pdev

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

SHAPES = st.tuples(
    st.integers(1, 120_000),  # rows
    st.integers(0, 1_200_000),  # columns
    st.integers(1, pdev.MAX_REPLICAS),  # replicas
    st.integers(0, 64),  # instance rows (MAX_WEIGHT)
)
SMALL = st.tuples(st.integers(1, 300), st.integers(0, 2500),
                  st.integers(1, pdev.MAX_REPLICAS), st.integers(0, 64))


def warps(plan, rows, n_cols, n_inst):
    """Each warp's (rows, tile positions) as the kernel cuts them: block b is
    row tile b // S and cluster rank b % S, which scores its rank's column
    tiles; warp w of a block holds rows 32 (w // W) .. + 32 of the tile, a
    row a lane, and scores part w % W of their positions."""
    for b in range(plan.grid):
        tile, rank = divmod(b, plan.slices)
        begin, end = plan.slice_tiles(rank)
        for w in range(pdev.TOPR_WARPS):
            r0 = tile * plan.tile_rows + w // plan.col_split * 32
            yield ((r0, min(r0 + 32, rows)),
                   plan.part_positions(w % plan.col_split, n_cols, n_inst, begin, end))


@settings(max_examples=150, deadline=None)
@given(SMALL)
def test_every_pair_is_scored_exactly_once(shape):
    """Every (row, tile position) pair once: a position holds one column,
    or with several instance rows one of its tile's columns sorted by
    weight, a permutation within the tile."""
    rows, n_cols, replicas, n_inst = shape
    plan = pdev.topr_plan(rows, n_cols, replicas, n_inst)
    seen = np.zeros((rows, n_cols), dtype=np.int64)
    assert (plan.row_tiles - 1) * plan.tile_rows < rows
    for (r0, r1), cols in warps(plan, rows, n_cols, n_inst):
        seen[r0:r1, cols] += 1
    assert (seen == 1).all()


@settings(max_examples=100, deadline=None)
@given(SMALL, st.sampled_from([1, 2, 4, 8]), st.integers(1, 16))
def test_every_split_and_slice_count_partitions_the_pairs(shape, split, slices):
    """The partition holds for every plan the kernel takes, not only the
    chosen one (the card tests force others)."""
    rows, n_cols, replicas, n_inst = shape
    base = pdev.topr_plan(rows, n_cols, replicas, n_inst)
    plan = pdev.ToprPlan(split, -(-rows // (pdev.TOPR_THREADS // split)), slices,
                         base.tile_cols, base.col_tiles, base.smem_bytes)
    seen = np.zeros((rows, n_cols), dtype=np.int64)
    for (r0, r1), cols in warps(plan, rows, n_cols, n_inst):
        seen[r0:r1, cols] += 1
    assert (seen == 1).all()


@settings(max_examples=400, deadline=None)
@given(SHAPES)
def test_the_plan_partitions_rows_and_columns(shape):
    rows, n_cols, replicas, n_inst = shape
    plan = pdev.topr_plan(rows, n_cols, replicas, n_inst)
    assert (plan.row_tiles - 1) * plan.tile_rows < rows <= plan.row_tiles * plan.tile_rows
    assert plan.col_tiles == -(-n_cols // plan.tile_cols)
    bounds = [plan.slice_tiles(k) for k in range(plan.slices)]
    assert bounds[0][0] == 0 and bounds[-1][1] == plan.col_tiles
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(begin <= end for begin, end in bounds)


@settings(max_examples=400, deadline=None)
@given(SHAPES)
def test_the_plan_stays_within_the_card(shape):
    rows, n_cols, replicas, n_inst = shape
    plan = pdev.topr_plan(rows, n_cols, replicas, n_inst)
    assert plan.slices in (1, 2, 4, 8, 16)
    assert plan.slices <= max(1, plan.col_tiles)
    assert plan.col_split in (1, 2, 4, 8)
    assert plan.tile_cols & (plan.tile_cols - 1) == 0
    assert pdev.TOPR_MIN_TILE <= plan.tile_cols <= pdev.TOPR_MAX_TILE
    assert plan.smem_bytes == pdev._topr_smem(plan.tile_cols, n_inst, replicas)
    assert plan.smem_bytes <= pdev.TOPR_MAX_SMEM
    assert plan.grid < 2**31


@settings(max_examples=400, deadline=None)
@given(SHAPES)
def test_the_grid_reaches_the_sms_where_rows_and_slices_allow(shape):
    rows, n_cols, replicas, n_inst = shape
    plan = pdev.topr_plan(rows, n_cols, replicas, n_inst)
    slices = max(1, min(pdev.TOPR_MAX_SLICES, plan.col_tiles))
    most = -(-rows // 32) * (1 << (slices.bit_length() - 1))  # W 8, S a power of two
    assert plan.grid >= min(pdev.TOPR_SMS, most)


@pytest.mark.parametrize("rows,n_cols,replicas,n_inst,merge,split,slices,tile", [
    (8192, 100_000, 3, 1, False, 1, 16, 512),  # the full build: grid 512
    (1024, 100_000, 3, 8, False, 8, 16, 512),  # the weighted map: grid 512
    (233, 100_000, 3, 1, False, 8, 16, 512),  # a view change's rows: grid 128, the most
    (8192, 1000, 3, 1, True, 1, 4, 128),  # the added-column merge: grid 128
    (1, 100_000, 3, 1, False, 8, 16, 512),  # one row: one cluster of 16
])
def test_the_planes_shapes_get_the_plans_timed_on_the_card(rows, n_cols, replicas, n_inst,
                                                             merge, split, slices, tile):
    """The planes' shapes get the plans PERF.md reports timed on an H100
    (``topr_variants.py --plans``): the fastest timed for each but the
    weighted map."""
    plan = pdev.topr_plan(rows, n_cols, replicas, n_inst, merge)
    assert (plan.col_split, plan.slices, plan.tile_cols) == (split, slices, tile), plan
    assert plan.grid >= min(pdev.TOPR_GRID_MERGE if merge else pdev.TOPR_SMS,
                            -(-rows // 32) * 16)


@settings(max_examples=200, deadline=None)
@given(SHAPES)
def test_the_merge_plan_partitions_and_fills_one_block_an_sm(shape):
    rows, n_cols, replicas, n_inst = shape
    plan = pdev.topr_plan(rows, n_cols, replicas, n_inst, merge=True)
    assert (plan.row_tiles - 1) * plan.tile_rows < rows <= plan.row_tiles * plan.tile_rows
    slices = max(1, min(pdev.TOPR_MAX_SLICES, plan.col_tiles))
    most = -(-rows // 32) * (1 << (slices.bit_length() - 1))
    assert plan.grid >= min(pdev.TOPR_GRID_MERGE, most)
    assert plan.smem_bytes <= pdev.TOPR_MAX_SMEM


def test_the_smallest_shapes_take_one_block():
    plan = pdev.topr_plan(1, 1, 1, 1)
    assert (plan.grid, plan.slices, plan.tile_cols) == (1, 1, pdev.TOPR_MIN_TILE)
    assert pdev.topr_plan(5, 0, 5, 3).col_tiles == 0


def test_the_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        pdev.topr_plan(8, 100, pdev.MAX_REPLICAS + 1, 1)
    with pytest.raises(ValueError):
        pdev.topr_plan(8, 100, 0, 1)
    with pytest.raises(ValueError, match="shared memory"):
        pdev.topr_plan(8, 100, 3, 1000)  # a ring of 32 columns of 1000 keys

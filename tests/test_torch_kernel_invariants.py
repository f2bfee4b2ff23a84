"""What the redesigned deposition and gather kernels rely on, pinned on the
CPU through their plain versions, and their launch geometry.

- The deposition kernels skip every slot whose val is 0: changing the
  offsets of such slots leaves the plain versions bit-equal.
- The gather kernel writes 0 for every slot whose weights on some axis vanish
  for both staggers, which it finds with a test on d alone (outside the hull
  of the tap centres widened by the spline's half-width): those slots get
  exactly 0 from the plain version.
- The launch geometries (reduced, packed and unfused deposition, fused and
  unfused gather) are pure functions of the shapes, stay within the card's 227 KB
  of shared memory and 1024 threads a block, and cover every column and
  cell exactly once.

Inputs are made with numpy from a seed; comparisons are exact.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import max_guard, packed_axis_weights, unified_support  # noqa: E402
from repro_torch.kernels.deposition import ops as dep  # noqa: E402
from repro_torch.kernels.deposition.ref import fused_bin_deposit_reduced_ref, fused_bin_deposit_ref  # noqa: E402
from repro_torch.kernels.gather import ops as gat  # noqa: E402
from repro_torch.kernels.gather.ref import fused_gather_ref  # noqa: E402

ORDERS = [1, 2, 3]
GRID = (4, 3, 5)
SMEM_LIMIT = 232_448
#: main path, lwfa, a tall column, and the capacity-320 test shape
SHAPES = [((128, 128, 128), 3, 32), ((8, 8, 64), 1, 48), ((2, 2, 256), 3, 24), ((3, 3, 3), 3, 320)]
SHAPE_IDS = ["main", "lwfa", "tall-column", "cap-320"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slab(order, grid=GRID, cap=12):
    """Slots with random occupancy: occupied ones in [0, 1) with random
    values, gap slots with val 0 and the offset of one aliased particle
    from their cell (some inside the tap windows, most outside)."""
    rng = np.random.default_rng(order)
    n_cells = int(np.prod(grid))
    occ = rng.integers(0, cap + 1, n_cells)
    occ[0], occ[1] = 0, cap
    d = rng.random((n_cells, cap, 3)).astype(np.float32)
    val = rng.normal(size=(n_cells, cap, 3)).astype(np.float32)
    gap = np.arange(cap)[None, :] >= occ[:, None]
    val[gap] = 0.0
    cells = np.stack(np.unravel_index(np.arange(n_cells), grid), axis=-1).astype(np.float32)
    alias = (rng.random(3) * np.asarray(grid)).astype(np.float32)
    d[gap] = (alias[None, :] - cells)[np.nonzero(gap)[0]]
    return torch.from_numpy(d), torch.from_numpy(val), torch.from_numpy(gap)


@pytest.mark.parametrize("order", ORDERS)
def test_offsets_of_zero_value_slots_do_not_change_the_deposition(order):
    d, val, _ = _slab(order)
    zero = (val == 0).all(dim=-1)
    assert bool(zero.any())
    moved = d.clone()
    moved[zero] = torch.from_numpy(np.random.default_rng(99).uniform(-3, 4, (int(zero.sum()), 3)).astype(np.float32))
    assert not torch.equal(moved, d)
    g = max_guard(order)
    assert torch.equal(fused_bin_deposit_ref(moved, val, order=order), fused_bin_deposit_ref(d, val, order=order))
    assert torch.equal(
        fused_bin_deposit_reduced_ref(moved, val, order=order, grid_shape=GRID, guard=g),
        fused_bin_deposit_reduced_ref(d, val, order=order, grid_shape=GRID, guard=g),
    )


def _dead_by_kernel_test(d, order):
    """The gather kernel's test (`axis_live` in csrc/fused_gather.cu): an
    axis is dead when d lies outside (base - h, base + T - 1/2 + h), h =
    (order + 1) / 2, the hull of the tap centres of both staggers widened by
    the spline's half-width; a slot with a dead axis gets zeros."""
    t, base = unified_support(order)
    h = 0.5 * (order + 1)
    far = (d <= base - h) | (d >= base + t - 0.5 + h)  # (C, cap, 3)
    return far.any(dim=-1)


@pytest.mark.parametrize("order", ORDERS)
def test_slots_with_a_vanishing_axis_gather_exact_zeros(order):
    grid = (9, 8, 10)  # wide enough that most aliased gap slots fall outside the windows
    d, _, gap = _slab(order, grid)
    dead = _dead_by_kernel_test(d, order)
    assert int(dead.sum()) > 0 and not bool(dead[~gap].any())
    assert bool((gap & ~dead).any()), "the fixture should also hold gap slots inside the windows"
    # what the kernel's test finds dead, the weights confirm: some axis has
    # all-zero weights for both staggers
    w = packed_axis_weights(d, order)
    vanishing = torch.stack([(w[(ax, False)] == 0).all(-1) & (w[(ax, True)] == 0).all(-1) for ax in range(3)]).any(0)
    assert bool(vanishing[dead].all())
    g = max_guard(order)
    padded = torch.from_numpy(
        np.random.default_rng(order).normal(size=(6, *(n + 2 * g for n in grid))).astype(np.float32))
    out = fused_gather_ref(d, padded, grid_shape=grid, order=order, guard=g)
    assert bool((out[vanishing] == 0).all())
    assert bool((out[~vanishing] != 0).any())


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_reduced_geometry_covers_every_column_once(shape):
    grid, order, _ = shape
    geo = dep.reduced_geometry(grid, order)
    assert geo == dep.reduced_geometry(tuple(grid), order)  # pure: same shapes, same launch
    t, _ = unified_support(order)
    assert geo.threads % 32 == 0 and geo.cols_per_block * 3 * t * t <= geo.threads <= min(1024, dep.DEPOSIT_THREADS)
    assert 0 < geo.smem <= SMEM_LIMIT
    seen = np.zeros(grid[0] * grid[1], dtype=int)
    for b in range(geo.blocks):
        cols = geo.columns(b)
        assert 1 <= len(cols) <= geo.cols_per_block
        seen[cols.start:cols.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_gather_geometry_covers_every_cell_once(shape):
    grid, order, cap = shape
    geo = gat.gather_geometry(grid, order, cap)
    assert geo == gat.gather_geometry(list(grid), order, cap)
    assert geo.threads % 32 == 0 and geo.threads <= 1024
    assert 0 < geo.smem <= SMEM_LIMIT and geo.smem == gat.gather_smem(order, geo.run, cap)
    seen = np.zeros(int(np.prod(grid)), dtype=int)
    for b in range(geo.blocks):
        cells = geo.cells(b)
        assert 1 <= len(cells) <= geo.run
        seen[cells.start:cells.stop] += 1
    assert (seen == 1).all()


#: (cells, order, cap) of the packed deposition: main path, lwfa, a tall
#: column, capacity 320, and a cell count whose last lane and block are
#: partial
PACKED_SHAPES = [(128**3, 3, 32), (8 * 8 * 64, 1, 48), (2 * 2 * 256, 3, 24), (27, 3, 320), (20_003, 2, 48)]
PACKED_IDS = SHAPE_IDS + ["partial-lane"]


@pytest.mark.parametrize("shape", PACKED_SHAPES, ids=PACKED_IDS)
def test_packed_geometry_covers_every_cell_once(shape):
    n_cells, order, cap = shape
    geo = dep.packed_geometry(n_cells, order, cap)
    assert geo == dep.packed_geometry(np.int64(n_cells), order, cap)  # pure: same shapes, same launch
    t, _ = unified_support(order)
    assert geo.threads % 32 == 0
    assert geo.lanes_per_block * 3 * t * t <= geo.threads <= min(1024, dep.DEPOSIT_THREADS)
    assert 0 < geo.smem <= SMEM_LIMIT and geo.smem == 4 * geo.lanes_per_block * dep.lane_floats(order)
    assert geo.cells_per_lane * math.ceil(cap / dep.DEPOSIT_CHUNK) <= dep.PACKED_STEPS or geo.cells_per_lane == 1
    seen = np.zeros(n_cells, dtype=int)
    for b in range(geo.blocks):
        cells = geo.cells(b)
        assert 1 <= len(cells) <= geo.lanes_per_block * geo.cells_per_lane
        seen[cells.start:cells.stop] += 1
    assert (seen == 1).all()


#: (cells, cap, M, N) of the unfused gather: the main path's Ex and Bx,
#: order 1's smallest, an odd capacity on an awkward cell count (ragged
#: groups), capacity 320, and the run-time-N instance's (M, N): an N no
#: stagger has, and an M over the templated sums' 5
BIN_GATHER_SHAPES = [(128**3, 32, 5, 16), (128**3, 32, 4, 25), (1001, 32, 2, 4), (203, 7, 5, 16), (27, 320, 5, 25),
                     (1001, 32, 3, 7), (1001, 7, 6, 16)]
BIN_GATHER_IDS = ["main-Ex", "main-Bx", "order-1", "odd-cap", "cap-320", "run-time-N", "M-over-5"]


@pytest.mark.parametrize("shape", BIN_GATHER_SHAPES, ids=BIN_GATHER_IDS)
def test_bin_gather_geometry_covers_every_cell_once(shape):
    n_cells, cap, m, n = shape
    geo = gat.bin_gather_geometry(n_cells, cap, m, n)
    assert geo == gat.bin_gather_geometry(np.int64(n_cells), cap, m, n)
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= min(1024, gat.BIN_GATHER_THREADS)
    assert 1 <= geo.stages <= gat.BIN_GATHER_HEADER // 8
    assert geo.smem == gat.BIN_GATHER_HEADER + 4 * geo.stages * gat.bin_gather_stage_floats(geo.group, cap, m, n)
    assert 0 < geo.smem <= SMEM_LIMIT
    seen = np.zeros(n_cells, dtype=int)
    for b in range(geo.blocks):
        for group in geo.groups(b):
            cells = geo.cells(group)
            assert 1 <= len(cells) <= geo.group
            seen[cells.start:cells.stop] += 1
    assert (seen == 1).all()


#: (cells, cap, M, N) of the unfused deposition: the main path's Jx and Jy,
#: order 1's smallest, ragged last groups at capacities that leave a cell's
#: runs off 16 bytes (7, 33) and at 32, capacity 128 (test_torch_modes'
#: largest shape), and an M over the templated sums' 5
OUTER_SHAPES = [(128**3, 32, 5, 16), (128**3, 32, 4, 20), (1001, 32, 3, 4), (1001, 7, 5, 16), (1001, 33, 4, 20),
                (203, 32, 2, 6), (512, 128, 4, 16), (1001, 7, 6, 16)]
OUTER_IDS = ["main-Jx", "main-Jy", "order-1", "cap-7", "cap-33", "ragged", "cap-128", "M-over-5"]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", OUTER_SHAPES, ids=OUTER_IDS)
def test_bin_outer_product_geometry_covers_every_cell_once(shape, dtype):
    n_cells, cap, m, n = shape
    geo = dep.bin_outer_product_geometry(n_cells, cap, m, n, dtype)
    assert geo == dep.bin_outer_product_geometry(np.int64(n_cells), cap, m, n, dtype)  # pure
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= min(1024, dep.OUTER_THREADS)
    assert 1 <= geo.stages <= dep.OUTER_HEADER // 8
    esize = 2 if dtype == torch.bfloat16 else 4
    a_run, b_run = cap * m * esize, cap * n * esize
    # the bulk route exactly when a cell's two runs are 16-byte multiples:
    # then every group's runs, the ragged last one's too, start and end on
    # 16-byte boundaries, in the operands and in the stage
    assert geo.bulk == (a_run % 16 == 0 and b_run % 16 == 0)
    header = dep.OUTER_HEADER if geo.bulk else 0
    assert geo.smem == header + geo.stages * geo.group * (a_run + b_run)
    assert 0 < geo.smem <= SMEM_LIMIT
    seen = np.zeros(n_cells, dtype=int)
    for b in range(geo.blocks):
        for group in geo.groups(b):
            cells = geo.cells(group)
            assert 1 <= len(cells) <= geo.group
            if geo.bulk:
                assert (cells.start * a_run) % 16 == (len(cells) * a_run) % 16 == 0
                assert (cells.start * b_run) % 16 == (len(cells) * b_run) % 16 == 0
                assert (geo.group * a_run) % 16 == 0  # the stage's b rows
            seen[cells.start:cells.stop] += 1
    assert (seen == 1).all()


def test_geometries_of_the_main_path_and_small_grids():
    """Several columns a block on the main path; one column a block, and
    runs short enough for two blocks an SM, on lwfa's 64 columns."""
    main = dep.reduced_geometry((128, 128, 128), 3)
    assert (main.cols_per_block, main.threads) == (5, 384)
    assert dep.reduced_geometry((8, 8, 64), 1).cols_per_block == 1
    assert gat.gather_geometry((128, 128, 128), 3, 32).run == 32
    lwfa = gat.gather_geometry((8, 8, 64), 1, 48)
    assert lwfa.blocks >= 2 * dep.SM_COUNT
    with pytest.raises(ValueError, match="shared memory"):
        gat.gather_geometry((4, 4, 4), 3, 60_000)
    # the packed deposition as the reduced one on the main path; its
    # shared memory does not grow with the capacity
    packed = dep.packed_geometry(128**3, 3, 32)
    assert (packed.lanes_per_block, packed.threads, packed.cells_per_lane) == (5, 384, 128)
    assert dep.packed_geometry(27, 3, 320).smem == dep.packed_geometry(27, 3, 24).smem
    # the unfused gather: 8-cell groups of one slot a thread, two blocks an
    # SM at order 3, every group aligned for the bulk copies
    for m, n in ((5, 16), (4, 20), (4, 25), (5, 20)):
        geo = gat.bin_gather_geometry(128**3, 32, m, n)
        assert (geo.group, geo.threads, geo.blocks) == (8, 256, 2 * dep.SM_COUNT) and geo.stages >= 3
    with pytest.raises(ValueError, match="shared memory"):
        gat.bin_gather_geometry(100, 3000, 5, 25)
    # the unfused deposition: two 256-thread blocks an SM at order 3, every
    # cell copied by the TMA; a cell over the shared memory raises
    for m, n, group in ((5, 16, 16), (4, 20, 12)):
        geo = dep.bin_outer_product_geometry(128**3, 32, m, n, torch.float32)
        assert (geo.group, geo.threads, geo.blocks, geo.bulk) == (group, 256, 2 * dep.SM_COUNT, True)
        assert geo.stages >= 2
    with pytest.raises(ValueError, match="shared memory"):
        dep.bin_outer_product_geometry(100, 3000, 5, 20, torch.float32)

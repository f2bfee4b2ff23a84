"""Wrappers of the deposition kernels: the functions the rest of the
package calls. Counterpart of `repro.kernels.deposition.ops`.

  fused_bin_deposit          the ``cuda`` rung of the ``deposit_fused`` op
  fused_bin_deposit_reduced  the ``cuda_reduced`` rung (top of ``auto``);
                             finish with `core.rhocell.reduce_rhocell_tail`
  bin_outer_product          the ``cuda`` rung of the ``deposit_unfused`` op
                             (``deposition="matrix_unfused"``)

Each checks its arguments and raises on what the kernel does not take. A
tensor on the CPU runs the plain PyTorch version (`ref.py`); a CUDA tensor
launches the kernel, and nothing else: a failed build or launch raises.
``LAUNCHES`` counts kernel launches, and only those.

Each also takes its operands with a leading member axis (an ensemble
bucket's, `repro_torch.pic.ensemble`) and then launches once for every
member: the members' cells are folded into one cell axis (member i's after
member i-1's), which is exact because a cell's tiles depend on that cell
alone, whichever block or lane computes them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.shape_functions import max_guard, unified_support
from repro_torch.kernels.deposition import kernel
from repro_torch.kernels.deposition.ref import (
    bin_outer_product_ref,
    fused_bin_deposit_reduced_ref,
    fused_bin_deposit_ref,
)

LAUNCHES = {"fused_bin_deposit": 0, "fused_bin_deposit_reduced": 0, "bin_outer_product": 0}

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448
#: SMs of an H100: a grid of fewer than two blocks a SM gets one lane a block
SM_COUNT = 132
#: shared memory of an SM, and what the card keeps of it for each block
SM_SMEM = 233_472
SM_BLOCK_RESERVE = 1024
#: most threads of a deposition block (`kDepositThreads` in the source)
DEPOSIT_THREADS = 384
#: slots the deposition kernels stage at a time (`kChunk`)
DEPOSIT_CHUNK = 32
#: raw chunks in flight or in use per lane (`kRawStages`)
DEPOSIT_RAW_STAGES = 4
#: most chunks a packed-kernel lane walks
PACKED_STEPS = 128
#: most threads of a `bin_outer_product` block (`kMaxThreads` in
#: bin_outer_product.cu)
OUTER_THREADS = 256
#: bytes of a `bin_outer_product` block before its ring: the stages'
#: mbarriers (bulk route only)
OUTER_HEADER = 128


class ReducedGeometry(NamedTuple):
    """Launch of `fused_deposit_reduced_kernel`: block b owns columns
    [b * cols_per_block, min((b + 1) * cols_per_block, n_cols))."""

    n_cols: int
    cols_per_block: int
    threads: int
    smem: int
    blocks: int

    def columns(self, block: int) -> range:
        start = block * self.cols_per_block
        return range(start, min(start + self.cols_per_block, self.n_cols))


class PackedGeometry(NamedTuple):
    """Launch of `fused_deposit_kernel`: block b owns lanes [b *
    lanes_per_block, (b + 1) * lanes_per_block) of cells_per_lane
    consecutive cells each, i.e. cells [b * lanes_per_block *
    cells_per_lane, ...) up to n_cells."""

    n_cells: int
    cells_per_lane: int
    lanes_per_block: int
    threads: int
    smem: int
    blocks: int

    def cells(self, block: int) -> range:
        per_block = self.lanes_per_block * self.cells_per_lane
        return range(block * per_block, min((block + 1) * per_block, self.n_cells))


def lane_floats(order: int) -> int:
    """Shared memory of one lane (a column, or a run of cells) in the
    deposition kernels, in floats: two buffers of 32 kept-slot records
    (wz[2] padded to a multiple of 4, av[3], wy[2], the record padded to a
    multiple of 4), four raw chunks of d and val, two lists of 32 slot
    indices and 4 counts (`Lane<ORDER>::FLOATS`)."""
    t, _ = unified_support(order)
    wzp = (t + 3) // 4 * 4
    record = (2 * wzp + 5 * t + 3) // 4 * 4
    return 2 * DEPOSIT_CHUNK * record + DEPOSIT_RAW_STAGES * 6 * DEPOSIT_CHUNK + 2 * DEPOSIT_CHUNK + 4


def _lanes_per_block(order: int, n_lanes: int) -> int:
    """As many lanes as 3*T^2 owner threads each fit in 384 threads and
    three blocks fit in an SM's shared memory, fewer where the grid would
    then give under two blocks an SM."""
    t, _ = unified_support(order)
    lane_bytes = 4 * lane_floats(order)
    return max(1, min(DEPOSIT_THREADS // (3 * t * t), SMEM_LIMIT // 3 // lane_bytes, n_lanes // (2 * SM_COUNT)))


def _threads(order: int, lanes: int) -> int:
    t, _ = unified_support(order)
    return (lanes * 3 * t * t + 31) // 32 * 32


def reduced_geometry(grid_shape, order: int, members: int = 1) -> ReducedGeometry:
    """Columns per block of the reduced kernel, a function of the grid,
    order and member count alone (one column a block at lwfa's 64
    columns). ``members`` grids stack their columns."""
    nx, ny, _ = (int(s) for s in grid_shape)
    n_cols = members * nx * ny
    k = _lanes_per_block(order, n_cols)
    return ReducedGeometry(n_cols, k, _threads(order, k), 4 * k * lane_floats(order), math.ceil(n_cols / k))


def packed_geometry(n_cells: int, order: int, cap: int) -> PackedGeometry:
    """Lanes of the packed kernel, a function of the cell count, order and
    capacity alone: lanes of up to 128 chunks (128 cells at capacity 32),
    shorter where the cells would then give under two blocks an SM; as many
    lanes a block as the reduced kernel takes columns. Shared memory does
    not depend on the capacity."""
    n_cells = int(n_cells)
    chunks = math.ceil(cap / DEPOSIT_CHUNK)
    k = _lanes_per_block(order, n_cells)
    per_lane = max(1, min(PACKED_STEPS // chunks, n_cells // (2 * SM_COUNT * k)))
    n_lanes = math.ceil(n_cells / per_lane)
    k = max(1, min(k, n_lanes // (2 * SM_COUNT)))
    return PackedGeometry(n_cells, per_lane, k, _threads(order, k), 4 * k * lane_floats(order),
                          math.ceil(n_lanes / k))


def _check_slab(d: torch.Tensor, val: torch.Tensor, order: int) -> None:
    if order not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2 or 3, got {order}")
    if d.dim() not in (3, 4) or d.shape[-1] != 3 or min(d.shape) < 1:
        raise ValueError(f"d must be (C, cap, 3) or (B, C, cap, 3), each >= 1, got {tuple(d.shape)}")
    if val.shape != d.shape:
        raise ValueError(f"val {tuple(val.shape)} must match d {tuple(d.shape)}")
    if d.dtype != torch.float32 or val.dtype != torch.float32:
        raise TypeError(f"d and val must be float32, got {d.dtype} and {val.dtype}")
    if d.device != val.device:
        raise ValueError(f"d and val on different devices: {d.device}, {val.device}")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {d.device}")
    if d.device.type == "cuda" and not (d.is_contiguous() and val.is_contiguous()):
        raise ValueError("d and val must be contiguous")


def _fold(x: torch.Tensor, dims: int) -> torch.Tensor:
    """``x`` of ``dims`` axes, or of ``dims + 1`` with a leading member
    axis, which is folded into the next one."""
    return x.reshape(-1, *x.shape[2:]) if x.dim() > dims else x


def _unfold(out: torch.Tensor, lead: tuple) -> torch.Tensor:
    """A folded output with its member axis ``lead`` (empty: none) back."""
    return out.reshape(*lead, -1, *out.shape[1:]) if lead else out


def fused_bin_deposit(d: torch.Tensor, val: torch.Tensor, *, order: int) -> torch.Tensor:
    """Fused Jx/Jy/Jz contraction: d, val (C, cap, 3) float32, val 0 on gap
    slots -> (C, 3, T, T*T) packed rhocell tiles on the unified window; with
    a member axis (B, C, cap, 3) -> (B, C, 3, T, T*T) in one launch. Any
    capacity: the kernel's shared memory depends on the order alone."""
    _check_slab(d, val, order)
    lead = d.shape[:-3]
    d, val = _fold(d, 3), _fold(val, 3)
    if d.device.type == "cpu":
        return _unfold(fused_bin_deposit_ref(d, val, order=order), lead)
    t, _ = unified_support(order)
    geometry = packed_geometry(d.shape[0], order, d.shape[1])
    out = torch.empty((d.shape[0], 3, t, t * t), dtype=torch.float32, device=d.device)
    kernel.fused_deposition_cuda(d, val, out, order=order, geometry=geometry)
    LAUNCHES["fused_bin_deposit"] += 1
    return _unfold(out, lead)


def fused_bin_deposit_reduced(d: torch.Tensor, val: torch.Tensor, *, order: int, grid_shape,
                              guard: int) -> torch.Tensor:
    """Fused deposition with the rhocell z pass in the kernel:
    d, val (nx*ny*nz, cap, 3) -> (nx*ny, 3, nz+2g, T, T); with a member
    axis (B, nx*ny*nz, cap, 3) -> (B, nx*ny, 3, nz+2g, T, T) in one launch,
    the members' columns one after another. Any capacity and column height:
    the kernel's shared memory depends on the order alone."""
    _check_slab(d, val, order)
    nx, ny, nz = (int(s) for s in grid_shape)
    if d.shape[-3] != nx * ny * nz:
        raise ValueError(f"{d.shape[-3]} cells do not fill grid {(nx, ny, nz)}")
    if guard < max_guard(order):
        raise ValueError(f"guard {guard} is below max_guard({order}) = {max_guard(order)}")
    lead = d.shape[:-3]
    d, val = _fold(d, 3), _fold(val, 3)
    if d.device.type == "cpu":
        return _unfold(fused_bin_deposit_reduced_ref(d, val, order=order, grid_shape=(nx, ny, nz), guard=guard),
                       lead)
    t, _ = unified_support(order)
    geometry = reduced_geometry((nx, ny, nz), order, members=math.prod(lead))
    out = torch.empty((geometry.n_cols, 3, nz + 2 * guard, t, t), dtype=torch.float32, device=d.device)
    kernel.fused_deposition_reduced_cuda(d, val, out, order=order, nz=nz, guard=guard, geometry=geometry)
    LAUNCHES["fused_bin_deposit_reduced"] += 1
    return _unfold(out, lead)


class OuterGeometry(NamedTuple):
    """Launch of `bin_outer_product_kernel`: ``blocks`` persistent blocks
    walk the groups of ``group`` consecutive cells, block b taking groups
    b, b + blocks, ..., through a ring of ``stages`` stages; ``bulk``: the
    stages are filled by TMA bulk copies (given 16-byte aligned operands),
    else by the threads, one element at a time."""

    n_cells: int
    group: int
    stages: int
    threads: int
    smem: int
    blocks: int
    bulk: bool

    def groups(self, block: int) -> range:
        return range(block, math.ceil(self.n_cells / self.group), self.blocks)

    def cells(self, group: int) -> range:
        return range(group * self.group, min((group + 1) * self.group, self.n_cells))


def bin_outer_product_geometry(n_cells: int, cap: int, m: int, n: int, dtype: torch.dtype) -> OuterGeometry:
    """The unfused deposition's launch, a function of the shapes alone:
    groups of cells holding ~256 columns (one a thread; 12 cells at N 20),
    fewer where two stages would not fit in half an SM's shared memory;
    up to four stages a block within that half, so two blocks share an SM;
    as many blocks as fit on the card at once, or one per group. The bulk
    route where a cell's a and b runs are 16-byte multiples (then so are a
    group's) and the stages' barriers fit beside one cell (`Ring` in
    csrc/bin_outer_product.cu). Raises if one cell is over the shared
    memory."""
    n_cells = int(n_cells)
    esize = 2 if dtype == torch.bfloat16 else 4
    a_run, b_run = cap * m * esize, cap * n * esize
    per_cell = a_run + b_run
    bulk = a_run % 16 == 0 and b_run % 16 == 0 and OUTER_HEADER + per_cell <= SMEM_LIMIT
    header = OUTER_HEADER if bulk else 0
    if header + per_cell > SMEM_LIMIT:
        raise ValueError(f"capacity {cap} needs {header + per_cell} B of shared memory per block, over {SMEM_LIMIT}")
    ring = SM_SMEM // 2 - SM_BLOCK_RESERVE - header  # two blocks an SM
    group = max(1, OUTER_THREADS // n)
    while group > 1 and 2 * group * per_cell > ring:
        group //= 2
    stage = group * per_cell
    stages = max(1, min(4, ring // stage, (SMEM_LIMIT - header) // stage))
    threads = min(OUTER_THREADS, max(32, (group * n + 31) // 32 * 32))
    smem = header + stages * stage
    per_sm = max(1, min(2048 // threads, SM_SMEM // (smem + SM_BLOCK_RESERVE)))
    blocks = min(math.ceil(n_cells / group), SM_COUNT * per_sm)
    return OuterGeometry(n_cells, group, stages, threads, smem, blocks, bulk)


def bin_outer_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-cell contraction out[c] = A_c^T B_c: a (C, cap, M), b (C, cap, N),
    both float32 or both bfloat16 -> (C, M, N) float32, accumulated in
    float32; with a member axis (B, C, ...) -> (B, C, M, N) in one launch.
    The reference's ``mode`` (MXU or VPU, a TPU unit) has no counterpart:
    the kernel has one route."""
    if a.dim() not in (3, 4) or b.dim() != a.dim() or a.shape[:-1] != b.shape[:-1] or min(a.shape) < 1 \
            or b.shape[-1] < 1:
        raise ValueError(f"a must be ([B,] C, cap, M) and b ([B,] C, cap, N), got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    lead = a.shape[:-3]
    a, b = _fold(a, 3), _fold(b, 3)
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a and b must both be float32 or both bfloat16, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a and b on different devices: {a.device}, {b.device}")
    if a.device.type == "cpu":
        return _unfold(bin_outer_product_ref(a, b), lead)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    cap, m, n = a.shape[1], a.shape[2], b.shape[2]
    if m * n > 1024:
        raise ValueError(f"an M x N tile of {m} x {n} is over the kernel's 1024 outputs a cell")
    geometry = bin_outer_product_geometry(a.shape[0], cap, m, n, a.dtype)
    out = torch.empty((a.shape[0], m, n), dtype=torch.float32, device=a.device)
    kernel.bin_outer_product_cuda(a, b, out, geometry=geometry)
    LAUNCHES["bin_outer_product"] += 1
    return _unfold(out, lead)

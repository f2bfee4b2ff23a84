"""Wrappers of the gather kernels. Counterpart of `repro.kernels.gather.ops`.

  fused_bin_gather  the ``cuda`` rung of the ``gather_fused`` op
  bin_gather        the ``cuda`` rung of the ``bin_gather`` op
                    (``gather="matrix_unfused"``)

Each checks its arguments and raises on what the kernel does not take. A
tensor on the CPU runs the plain PyTorch version (`ref.py`); a CUDA tensor
launches the kernel, and nothing else. ``LAUNCHES`` counts kernel launches,
and only those.

Each also takes its operands with a leading member axis (an ensemble
bucket's) and then launches once for every member. `bin_gather` folds the
members' cells into one cell axis, as the deposition wrappers do; the
fused gather reads each member's own grids, so its blocks decode their
member and offset into that member's grids and slab.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.shape_functions import max_guard, unified_support
from repro_torch.kernels.deposition.ops import SM_BLOCK_RESERVE, SM_COUNT, SM_SMEM, SMEM_LIMIT, _fold, _unfold
from repro_torch.kernels.gather import kernel
from repro_torch.kernels.gather.ref import bin_gather_ref, fused_gather_ref

LAUNCHES = {"fused_bin_gather": 0, "bin_gather": 0}

#: threads of a fused-gather block (`kGatherThreads` in the source)
GATHER_THREADS = 160
#: most z cells one fused-gather block takes
GATHER_RUN = 32
#: most threads of an unfused-gather block (`kMaxThreads` in bin_gather.cu)
BIN_GATHER_THREADS = 512
#: bytes of an unfused-gather block before its ring: the stages' mbarriers
BIN_GATHER_HEADER = 128


class GatherGeometry(NamedTuple):
    """Launch of `fused_gather_kernel`: block b takes z cells
    [z0, min(z0 + run, nz)) of column b // runs, z0 = (b % runs) * run, the
    columns of ``members`` grids one after another."""

    grid_shape: tuple
    run: int
    threads: int
    smem: int
    blocks: int
    members: int = 1

    def cells(self, block: int) -> range:
        """The flat (z-fastest) cell indices of ``block``, counted over the
        members' cells one after another."""
        _, _, nz = self.grid_shape
        runs = math.ceil(nz / self.run)
        column, z0 = divmod(block, runs)
        z0 *= self.run
        return range(column * nz + z0, column * nz + min(z0 + self.run, nz))


def gather_smem(order: int, run: int, cap: int) -> int:
    """Shared memory of a fused-gather block, in bytes: the run's rows of
    the six padded grids, G[6][T][T][run + T - 1] padded to a multiple of 4
    floats, the run's offsets D[run][cap][3], then the listed slots
    live[run][cap], n_live[run] and first[run + 1] (ints)."""
    t, _ = unified_support(order)
    g_floats = (6 * t * t * (run + t - 1) + 3) // 4 * 4
    return 4 * (g_floats + 4 * run * cap + 2 * run + 1)


def gather_geometry(grid_shape, order: int, cap: int, members: int = 1) -> GatherGeometry:
    """Cells per fused-gather block, a function of the grid, order,
    capacity and member count alone: runs of up to 32 z cells, fewer at
    capacities over 128 (the offsets and slot lists grow with run x cap),
    halved until the members' grids give at least two blocks an SM (lwfa's
    8 x 8 x 64). Raises if even one cell a block is over the shared
    memory."""
    nx, ny, nz = (int(s) for s in grid_shape)
    cols = members * nx * ny
    run = max(1, min(GATHER_RUN, nz, 4096 // cap))
    while run > 1 and cols * math.ceil(nz / run) < 2 * SM_COUNT:
        run = (run + 1) // 2
    smem = gather_smem(order, run, cap)
    if smem > SMEM_LIMIT:
        raise ValueError(f"capacity {cap} needs {smem} B of shared memory per block, over {SMEM_LIMIT}")
    return GatherGeometry((nx, ny, nz), run, GATHER_THREADS, smem, cols * math.ceil(nz / run), members)


def fused_bin_gather(d: torch.Tensor, padded: torch.Tensor, *, grid_shape, order: int, guard: int) -> torch.Tensor:
    """Fused Ex..Bz gather: d (C, cap, 3) slab offsets and the six stacked
    guard-padded grids (6, nx+2g, ny+2g, nz+2g) -> (C, cap, 6) float32
    per-bin values in EB_STAGGERS order; with a member axis, d (B, C, cap,
    3) and padded (B, 6, ...) -> (B, C, cap, 6) in one launch."""
    if order not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2 or 3, got {order}")
    nx, ny, nz = (int(s) for s in grid_shape)
    lead = d.shape[:-3]
    if d.dim() not in (3, 4) or d.shape[-1] != 3 or min(d.shape) < 1 or d.shape[-3] != nx * ny * nz:
        raise ValueError(f"d must be ([B,] {nx * ny * nz}, cap, 3) for grid {(nx, ny, nz)}, got {tuple(d.shape)}")
    if guard < max_guard(order):
        raise ValueError(f"guard {guard} is below max_guard({order}) = {max_guard(order)}")
    want = (*lead, 6, nx + 2 * guard, ny + 2 * guard, nz + 2 * guard)
    if tuple(padded.shape) != want:
        raise ValueError(f"padded must be {want}, got {tuple(padded.shape)}")
    if d.dtype != torch.float32 or padded.dtype != torch.float32:
        raise TypeError(f"d and padded must be float32, got {d.dtype} and {padded.dtype}")
    if d.device != padded.device:
        raise ValueError(f"d and padded on different devices: {d.device}, {padded.device}")
    if d.device.type == "cpu":
        return fused_gather_ref(d, padded, grid_shape=(nx, ny, nz), order=order, guard=guard)
    if d.device.type != "cuda":
        raise ValueError(f"unsupported device {d.device}")
    if not (d.is_contiguous() and padded.is_contiguous()):
        raise ValueError("d and padded must be contiguous")
    geometry = gather_geometry((nx, ny, nz), order, d.shape[-2], members=math.prod(lead))
    out = torch.empty((*d.shape[:-1], 6), dtype=torch.float32, device=d.device)
    kernel.fused_gather_cuda(d, padded, out, grid_shape=(nx, ny, nz), order=order, guard=guard, geometry=geometry)
    LAUNCHES["fused_bin_gather"] += 1
    return out


class BinGatherGeometry(NamedTuple):
    """Launch of `bin_gather_kernel`: ``blocks`` persistent blocks walk the
    groups of ``group`` consecutive cells, block b taking groups b, b +
    blocks, ..., through a ring of ``stages`` stages."""

    n_cells: int
    group: int
    stages: int
    threads: int
    smem: int
    blocks: int

    def groups(self, block: int) -> range:
        return range(block, math.ceil(self.n_cells / self.group), self.blocks)

    def cells(self, group: int) -> range:
        return range(group * self.group, min((group + 1) * self.group, self.n_cells))


def bin_gather_stage_floats(group: int, cap: int, m: int, n: int) -> int:
    """Floats of one stage of the unfused gather's ring: the group's wx
    rows, byz rows and g tiles, each padded to a multiple of 4
    (`Ring::stage_floats`)."""
    return sum((k + 3) // 4 * 4 for k in (group * cap * m, group * cap * n, group * m * n))


def bin_gather_geometry(n_cells: int, cap: int, m: int, n: int) -> BinGatherGeometry:
    """The unfused gather's launch, a function of the shapes alone: groups
    of a multiple of 4 cells holding ~256 slots (one a thread; 8 cells at
    capacity 32), fewer where two stages would not fit; up to four stages
    a block within half an SM's shared memory, so two blocks share an SM
    at order 3; as many blocks as fit on the card at once, or one per
    group. Raises if one cell is over the shared memory."""
    n_cells = int(n_cells)
    per_cell = 4 * bin_gather_stage_floats(1, cap, m, n)
    if BIN_GATHER_HEADER + per_cell > SMEM_LIMIT:
        raise ValueError(f"capacity {cap} needs {BIN_GATHER_HEADER + per_cell} B of shared memory per block, "
                         f"over {SMEM_LIMIT}")
    group = 4 * max(1, 256 // (4 * cap))
    while group > 1 and BIN_GATHER_HEADER + 2 * 4 * bin_gather_stage_floats(group, cap, m, n) > SMEM_LIMIT:
        group //= 2
    stage = 4 * bin_gather_stage_floats(group, cap, m, n)
    ring = SM_SMEM // 2 - SM_BLOCK_RESERVE - BIN_GATHER_HEADER  # two blocks an SM
    stages = max(1, min(4, ring // stage, (SMEM_LIMIT - BIN_GATHER_HEADER) // stage))
    threads = min(BIN_GATHER_THREADS, max(32, (group * cap + 31) // 32 * 32))
    smem = BIN_GATHER_HEADER + stages * stage
    per_sm = max(1, min(2048 // threads, SM_SMEM // (smem + SM_BLOCK_RESERVE)))
    blocks = min(math.ceil(n_cells / group), SM_COUNT * per_sm)
    return BinGatherGeometry(n_cells, group, stages, threads, smem, blocks)


def bin_gather(wx: torch.Tensor, byz: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """One component's per-bin gather: wx (C, cap, M), byz (C, cap, N) and
    the cells' neighbourhoods g (C, M, N), float32 -> (C, cap) float32;
    with a member axis (B, C, ...) -> (B, C, cap) in one launch."""
    if wx.dim() not in (3, 4) or byz.dim() != wx.dim() or g.dim() != wx.dim() or wx.shape[:-1] != byz.shape[:-1] \
            or min(wx.shape) < 1:
        raise ValueError(f"wx must be ([B,] C, cap, M) and byz ([B,] C, cap, N), got {tuple(wx.shape)}, "
                         f"{tuple(byz.shape)}")
    lead = wx.shape[:-3]
    if tuple(g.shape) != (*wx.shape[:-2], wx.shape[-1], byz.shape[-1]):
        raise ValueError(f"g must be {(*wx.shape[:-2], wx.shape[-1], byz.shape[-1])}, got {tuple(g.shape)}")
    wx, byz, g = _fold(wx, 3), _fold(byz, 3), _fold(g, 3)
    c, cap, m = wx.shape
    n = byz.shape[2]
    if not wx.dtype == byz.dtype == g.dtype == torch.float32:
        raise TypeError(f"wx, byz and g must be float32, got {wx.dtype}, {byz.dtype}, {g.dtype}")
    if not wx.device == byz.device == g.device:
        raise ValueError(f"wx, byz and g on different devices: {wx.device}, {byz.device}, {g.device}")
    if wx.device.type == "cpu":
        return _unfold(bin_gather_ref(wx, byz, g), lead)
    if wx.device.type != "cuda":
        raise ValueError(f"unsupported device {wx.device}")
    if not (wx.is_contiguous() and byz.is_contiguous() and g.is_contiguous()):
        raise ValueError("wx, byz and g must be contiguous")
    geometry = bin_gather_geometry(c, cap, m, n)
    out = torch.empty((c, cap), dtype=torch.float32, device=wx.device)
    kernel.bin_gather_cuda(wx, byz, g, out, geometry=geometry)
    LAUNCHES["bin_gather"] += 1
    return _unfold(out, lead)

"""Cell binning: the paper's ``GlobalSortParticlesByCell`` (counting sort).

Counterpart of `repro.core.binning`. The binned layout is the same GPMA
storage:

  slots:          (n_cells, capacity) int32 — particle index or INVALID (-1)
  particle_slot:  (n_particles,)       int32 — flat slot of each particle
                                               (INVALID if dead / overflowed)

Cells are flattened z-fastest, ``(x * ny + y) * nz + z``. Every rank is
taken with a stable argsort, so slots come out exactly as the reference's.

An ensemble bucket's layout carries a leading member axis: ``slots``
(B, n_cells, capacity) and ``particle_slot`` (B, n_particles), each
member's ids and slots its own, exactly as in its solo run. The binning
functions take it by folding the members into one problem of B·n_cells
bins and B·n_particles particles, member i's after member i-1's
(`fold_cells`, `member_offsets`): every rank is within a bin, and a stable
sort keeps each member's particles in their own order, so each member's
bins are its solo bins. The slot table is written with member-local ids
from the start, so only per-particle indices are ever offset.
The slot-table gather and the global sort's permutation go through
`repro_torch.grad.permutations`, as the reference's go through
`repro.grad.permutations`.
"""

from __future__ import annotations

import dataclasses

import torch

# the differentiable index movement (re-exported: `binning.slot_gather` and
# `binning.permute_tree` are the names the core layer calls)
from repro_torch.grad.permutations import member_offsets, permute_tree, slot_gather  # noqa: F401

INVALID = -1

#: slot-table slab stagings run (`build_bin_slab`, `bin_slab_staging`):
#: the reference's counter, which its tests read to hold one staging a
#: fused step. Here a staging adds one each time it runs (eagerly, or when
#: a window's step is captured or warmed up), never during a replay.
SLAB_BUILDS = 0


@dataclasses.dataclass(frozen=True)
class BinnedLayout:
    """GPMA index state."""

    slots: torch.Tensor          # (n_cells, capacity) int32, particle id or -1
    particle_slot: torch.Tensor  # (n_particles,) int32, flat slot id or -1

    @property
    def n_cells(self) -> int:
        return self.slots.shape[-2]

    @property
    def capacity(self) -> int:
        return self.slots.shape[-1]

    def valid_mask(self) -> torch.Tensor:
        return self.slots >= 0

    def n_empty(self) -> torch.Tensor:
        """Empty slots: a 0-d tensor, or one a member with a member axis."""
        if self.slots.dim() > 2:
            return torch.sum(self.slots < 0, dim=(-2, -1))
        return torch.sum(self.slots < 0)


def member_local(index: torch.Tensor, per_member: int | None) -> torch.Tensor:
    """Indices into the members' rows one after another (each member
    ``per_member`` rows) as member-local ones; -1 stays -1. ``None``: no
    member axis, the indices as they are."""
    if per_member is None:
        return index
    return torch.where(index >= 0, torch.remainder(index, per_member), index)


def fold_cells(cell_ids: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Member-local cell ids (B, N) as ids of the members' cells one after
    another, flattened."""
    cell_ids = cell_ids.long()
    return (cell_ids + member_offsets(cell_ids, n_cells)).reshape(-1)


@dataclasses.dataclass(frozen=True)
class BinSlab:
    """Bin-resident particle staging slab, built once per step.

      d:      (n_cells, capacity, 3) fractional offsets pos - cell. Gap
              slots alias particle 0; `valid` or the zeroed value slab
              carries the masking.
      valid:  (n_cells, capacity) bool, True where the slot holds a particle.
    """

    d: torch.Tensor
    valid: torch.Tensor


def cell_coords(n_cells: int, grid_shape, device=None) -> torch.Tensor:
    """(n_cells, 3) integer coordinates of each flattened cell id."""
    nx, ny, nz = grid_shape
    c = torch.arange(n_cells, dtype=torch.int32, device=device)
    iz = c % nz
    iy = (c // nz) % ny
    ix = c // (ny * nz)
    return torch.stack([ix, iy, iz], dim=-1)


def cell_index(pos: torch.Tensor, grid_shape) -> torch.Tensor:
    """Flattened int64 cell id for positions in grid units. pos: (..., 3).
    Each coordinate is clipped into the box: a wrapped position that rounds
    to exactly the box length belongs to the last cell."""
    nx, ny, nz = grid_shape
    ix = torch.floor(pos[..., 0]).long().clamp(0, nx - 1)
    iy = torch.floor(pos[..., 1]).long().clamp(0, ny - 1)
    iz = torch.floor(pos[..., 2]).long().clamp(0, nz - 1)
    return (ix * ny + iy) * nz + iz


def build_bin_slab(pos: torch.Tensor, layout: BinnedLayout, *, grid_shape) -> BinSlab:
    """The slot-table slab gather: stage positions into bin order once."""
    global SLAB_BUILDS
    SLAB_BUILDS += 1
    slots = layout.slots
    valid = slots >= 0
    pos_b = slot_gather(pos, slots)
    cells = cell_coords(slots.shape[-2], grid_shape, device=pos.device)
    d = pos_b - cells[:, None, :].to(pos.dtype)
    return BinSlab(d=d, valid=valid)


def bin_slab_staging(pos, vel, qw, layout: BinnedLayout, *, grid_shape):
    """Positions and the post-push q·w·v deposition values through ONE
    slot-table gather of the column-concatenated (N, 7) matrix.

    Returns ``(BinSlab, values)`` with `values` the (n_cells, capacity, 3)
    q·w·v slab, exactly 0 on gap/overflow slots."""
    global SLAB_BUILDS
    SLAB_BUILDS += 1
    slots = layout.slots
    valid = slots >= 0
    packed = torch.cat([pos, vel, qw[..., None]], dim=-1)  # (N, 7)
    staged = slot_gather(packed, slots)                      # (C, cap, 7) — once
    cells = cell_coords(slots.shape[-2], grid_shape, device=pos.device)
    d = staged[..., :3] - cells[:, None, :].to(pos.dtype)
    zero = torch.zeros((), dtype=qw.dtype, device=qw.device)
    qw_b = torch.where(valid, staged[..., 6], zero)
    vel_b = torch.where(valid[..., None], staged[..., 3:6], zero)
    return BinSlab(d=d.contiguous(), valid=valid), qw_b[..., None] * vel_b


def bin_slab_values(vel, qw, layout: BinnedLayout, slab: BinSlab) -> torch.Tensor:
    """Per-component deposition values q·w·v staged onto the slab's slot
    table: (n_cells, capacity, 3), exactly 0 on gap/overflow slots."""
    valid = slab.valid
    zero = torch.zeros((), dtype=qw.dtype, device=qw.device)
    qw_b = torch.where(valid, slot_gather(qw, layout.slots), zero)
    vel_b = torch.where(valid[..., None], slot_gather(vel, layout.slots), zero)
    return qw_b[..., None] * vel_b


def _stable_ranks(key: torch.Tensor):
    """Stable counting-sort ranks: ``(order, sorted_key, rank)`` with
    ``rank[i]`` the position of ``sorted_key[i]`` within its run of equal
    keys."""
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    first = torch.searchsorted(sorted_key, sorted_key, side="left")
    rank = torch.arange(key.shape[0], device=key.device) - first
    return order, sorted_key, rank


def build_bins(cell_ids: torch.Tensor, alive: torch.Tensor, *, n_cells: int, capacity: int):
    """Counting-sort rebuild of the binned layout.

    Dead particles get particle_slot = -1. Particles whose within-cell rank
    reaches `capacity` overflow: they stay unslotted and are counted.

    Returns ``(layout, overflow_count)`` with the count a 0-d device tensor.
    With a member axis, ``cell_ids`` and ``alive`` (B, N) give each
    member's bins (B, n_cells, capacity) and its count (B,).
    """
    if cell_ids.dim() > 1:
        b, n = cell_ids.shape
        layout, _ = _build_bins(fold_cells(cell_ids, n_cells), alive.reshape(-1), n_cells=b * n_cells,
                                capacity=capacity, members=(n, n_cells * capacity))
        layout = BinnedLayout(slots=layout.slots.reshape(b, n_cells, capacity),
                              particle_slot=layout.particle_slot.reshape(b, n))
        # the particles that found no slot are the overflow
        return layout, torch.sum(alive, dim=-1) - torch.sum(layout.particle_slot >= 0, dim=-1)
    return _build_bins(cell_ids, alive, n_cells=n_cells, capacity=capacity)


def _build_bins(cell_ids: torch.Tensor, alive: torch.Tensor, *, n_cells: int, capacity: int, members=None):
    """`build_bins` of one problem; with ``members`` = (particles, slots)
    of each member, of the members folded one after another, its ids and
    slots written member-local."""
    n = cell_ids.shape[0]
    dev = cell_ids.device
    key = torch.where(alive, cell_ids.long(), n_cells)   # dead -> sentinel bin
    order, sorted_key, rank = _stable_ranks(key)

    live = sorted_key < n_cells
    in_range = live & (rank < capacity)
    overflow = torch.sum(live & (rank >= capacity))

    dump = n_cells * capacity
    flat_slot = torch.where(in_range, sorted_key * capacity + rank, dump)
    # every rejected entry lands in the one dump slot, dropped afterwards
    slots = torch.full((dump + 1,), INVALID, dtype=torch.int32, device=dev)
    per_ids, per_slots = members or (None, None)
    slots[flat_slot] = member_local(order, per_ids).to(torch.int32)
    particle_slot = torch.full((n,), INVALID, dtype=torch.int32, device=dev)
    particle_slot[order] = member_local(torch.where(in_range, flat_slot, INVALID), per_slots).to(torch.int32)
    layout = BinnedLayout(slots=slots[:-1].reshape(n_cells, capacity), particle_slot=particle_slot)
    return layout, overflow


def sort_permutation(cell_ids: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Permutation putting alive particles in cell order (the global sort's
    attribute permutation); dead particles go last, in index order. With a
    member axis (B, N), each member's own permutation (B, N), from one sort
    of the members' keys one after another."""
    key = torch.where(alive, cell_ids.long(), 2**30)
    if key.dim() > 1:
        b, n = key.shape
        perm = torch.argsort((key + member_offsets(key, 2**31)).reshape(-1), stable=True).reshape(b, n)
        return perm - member_offsets(perm, n)
    return torch.argsort(key, stable=True)


def choose_capacity(max_ppc: int, headroom: float = 1.5, multiple: int = 8) -> int:
    """Bin capacity with GPMA gap headroom, rounded to a multiple of 8."""
    cap = int(max(1, max_ppc) * headroom) + 1
    return ((cap + multiple - 1) // multiple) * multiple

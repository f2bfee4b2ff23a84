"""Incremental particle sorting on a gapped binned layout (functional GPMA).

Counterpart of `repro.core.gpma` (paper §4.3): only particles that changed
cell are deleted from their old bin and inserted into a gap of the new one;
the attribute arrays are never touched. Insert ranks come from one stable
key-only argsort, so the slots match the reference exactly.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.binning import INVALID, BinnedLayout, _stable_ranks, fold_cells, member_local, member_offsets


@dataclasses.dataclass(frozen=True)
class GPMAStats:
    """Per-step device-side statistics consumed by the resort policy
    (0-d int64 tensors)."""

    n_moved: torch.Tensor     # particles that changed cell, plus unslotted
                              # live particles whose insert landed
    n_overflow: torch.Tensor  # inserts that found no gap (-> rebuild needed)
    n_empty: torch.Tensor     # empty slots after update
    n_alive: torch.Tensor     # live particles


def gpma_update(layout: BinnedLayout, new_cell: torch.Tensor, alive: torch.Tensor):
    """Delete moved particles from their old bins, insert them into gaps of
    their new bins.

    Args:
      layout: current binned layout (bins reflect pre-push cells).
      new_cell: (n_particles,) flattened cell ids after the push.
      alive: (n_particles,) bool.

    Returns ``(new_layout, GPMAStats)``. Overflowed particles have
    particle_slot == -1 and sit in no bin; the caller must rebuild.

    With a member axis (a bucket's layout, ``new_cell`` and ``alive`` (B,
    n_particles)), every member is updated at once, its members folded into
    one problem of B·n_cells bins, member i's after member i-1's: each
    member's bins come out as its solo update's, and each statistic is one
    count a member (B,).
    """
    if alive.dim() > 1:
        b, n = alive.shape
        n_cells, cap = layout.slots.shape[-2:]
        pslot = layout.particle_slot
        folded = BinnedLayout(slots=layout.slots.reshape(b * n_cells, cap),
                              particle_slot=torch.where(pslot >= 0, pslot + member_offsets(pslot, n_cells * cap),
                                                        pslot).reshape(-1))
        flat, masks = _update(folded, fold_cells(new_cell, n_cells), alive.reshape(-1),
                              members=(n, n_cells * cap))
        moved, had_slot, landed, needs_insert = (m.reshape(b, -1) for m in masks[:4])
        per_member = lambda x: torch.sum(x, dim=-1)
        stats = GPMAStats(
            n_moved=per_member(moved) + per_member(landed & ~had_slot),
            n_overflow=per_member(needs_insert & ~landed),  # an insert that found no gap lands nowhere
            n_empty=per_member(flat.slots.reshape(b, -1) < 0),
            n_alive=per_member(alive),
        )
        return BinnedLayout(slots=flat.slots.reshape(b, n_cells, cap),
                            particle_slot=flat.particle_slot.reshape(b, n)), stats
    new_layout, (moved, had_slot, landed, _, is_insert, fits) = _update(layout, new_cell, alive)
    stats = GPMAStats(
        n_moved=torch.sum(moved) + torch.sum(landed & ~had_slot),
        n_overflow=torch.sum(is_insert & ~fits),
        n_empty=torch.sum(new_layout.slots < 0),
        n_alive=torch.sum(alive),
    )
    return new_layout, stats


def _update(layout: BinnedLayout, new_cell: torch.Tensor, alive: torch.Tensor, members=None):
    """`gpma_update` of one layout without its statistics. Returns the new
    layout and the masks the statistics count: per particle ``moved``,
    ``had_slot``, ``landed`` and ``needs_insert``; per sorted insert
    ``is_insert`` and ``fits``. With ``members`` = (particles, slots) of
    each member, the layout is the members' folded one after another, its
    slot table holding member-local ids: the new ids and particle slots are
    written member-local too."""
    n_cells, cap = layout.slots.shape
    n = new_cell.shape[0]
    dev = new_cell.device
    new_cell = new_cell.long()

    old_slot = layout.particle_slot.long()
    had_slot = old_slot >= 0
    old_cell = torch.where(had_slot, old_slot // cap, -1)

    moved = alive & had_slot & (new_cell != old_cell)
    died = ~alive & had_slot
    needs_insert = alive & (new_cell != old_cell)  # moved or previously unslotted

    # delete: free the old slots of moved and dead particles; every other
    # entry writes the one dump slot, dropped afterwards
    free_src = moved | died
    dump = n_cells * cap
    flat = torch.cat([layout.slots.reshape(-1), layout.slots.new_zeros(1)])
    flat.index_fill_(0, torch.where(free_src, old_slot, dump), INVALID)
    slots = flat[:-1].reshape(n_cells, cap)

    # insert: rank pending moves within their target bin
    key = torch.where(needs_insert, new_cell, n_cells)
    order, sorted_key, rank = _stable_ranks(key)

    # r-th gap of each bin: stable argsort of the int-cast "occupied" flag
    free_mask = slots < 0
    free_order = torch.argsort((~free_mask).to(torch.int8), dim=1, stable=True)
    n_free = torch.sum(free_mask, dim=1)

    tgt = torch.clamp_max(sorted_key, n_cells - 1)
    is_insert = sorted_key < n_cells
    fits = is_insert & (rank < n_free[tgt])
    dst = tgt * cap + free_order[tgt, torch.clamp_max(rank, cap - 1)]
    dst = torch.where(fits, dst, dump)

    per_ids, per_slots = members or (None, None)
    flat = torch.cat([slots.reshape(-1), slots.new_zeros(1)])
    flat[dst] = member_local(order, per_ids).to(torch.int32)
    slots = flat[:-1].reshape(n_cells, cap)

    # particle_slot bookkeeping (order is a permutation: no repeated index)
    pslot = torch.where(free_src, INVALID, old_slot)
    upd = torch.where(fits, dst, INVALID)
    pslot[order] = torch.where(is_insert, upd, pslot[order])

    landed = torch.zeros(n, dtype=torch.bool, device=dev)
    landed[order] = fits
    layout = BinnedLayout(slots=slots, particle_slot=member_local(pslot, per_slots).to(torch.int32))
    return layout, (moved, had_slot, landed, needs_insert, is_insert, fits)

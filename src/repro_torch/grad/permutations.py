"""Autograd rules for the sorter's index machinery. Counterpart of
`repro.grad.permutations`.

Every reordering the simulation performs — the global sort's attribute
permutation and the GPMA slot table's bin-order gathers (`build_bin_slab`,
`bin_slab_staging`, `bin_slab_values`) — is piecewise constant in the
physics values: the indices are integer functions of the positions whose
derivative is zero almost everywhere. Reverse mode needs two things from
them:

1. the index carries no gradient (its backward returns ``None``), and
2. the value movement is the linear map ``values -> values[perm]``, whose
   transpose is an ``index_add_`` at ``perm``.

`slot_gather` fixes the one place the native rule is wrong: slot tables pad
gap and overflow slots with ``-1``, which the forward clamps to 0, aliasing
particle 0; its backward masks those slots out, so particle 0 never
collects the pads' cotangents.

Forwards are bit-identical to the raw indexing they stand for:
``permute_values(v, perm) == v[perm]`` and ``slot_gather(v, slots) ==
v[clamp_min(slots, 0)]``. A tensor that carries no gradient (an int or
bool leaf, or any tensor outside autograd) is indexed directly.

This module imports only torch: `core.binning` depends on it.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["permute_values", "permute_tree", "slot_gather"]


def _tracked(values: torch.Tensor) -> bool:
    return values.requires_grad and torch.is_grad_enabled()


class _PermuteValues(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, perm):
        ctx.save_for_backward(perm)
        ctx.shape = values.shape
        return values[perm]

    @staticmethod
    def backward(ctx, ct):
        (perm,) = ctx.saved_tensors
        return ct.new_zeros(ctx.shape).index_add_(0, perm, ct), None


def permute_values(values: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``values[perm]`` along axis 0, whose backward scatter-adds the
    cotangent back through ``perm``; the index gets no gradient."""
    perm = perm.long()
    return _PermuteValues.apply(values, perm) if _tracked(values) else values[perm]


def member_offsets(like: torch.Tensor, stride: int) -> torch.Tensor:
    """Member i's offset ``i * stride``, shaped (B, 1, ...) to broadcast
    against ``like`` (B, ...): member-local indices plus these index the
    members' rows one after another, each member ``stride`` rows."""
    b = like.shape[0]
    off = torch.arange(b, device=like.device, dtype=like.dtype) * stride
    return off.reshape(b, *([1] * (like.dim() - 1)))


def permute_tree(tree, perm: torch.Tensor):
    """Apply one permutation to every tensor of a dataclass or dict (axis 0).

    Float leaves go through `permute_values`; int and bool leaves (cell
    ids, alive flags, slot bookkeeping) carry no gradient and are indexed
    directly. With a member axis, ``perm`` (B, N) permutes each member's
    leaves (B, N, ...) along axis 1 by its own row."""
    perm = perm.long()
    if perm.dim() > 1:
        b, n = perm.shape
        items = tree.items() if isinstance(tree, dict) else ((f.name, getattr(tree, f.name))
                                                            for f in dataclasses.fields(tree))
        folded = {k: v.reshape(b * n, *v.shape[2:]) for k, v in items}
        moved = permute_tree(folded, (perm + member_offsets(perm, n)).reshape(-1))
        out = {k: v.reshape(b, n, *v.shape[1:]) for k, v in moved.items()}
        return out if isinstance(tree, dict) else dataclasses.replace(tree, **out)

    def move(a):
        return permute_values(a, perm) if a.is_floating_point() else a[perm]

    if isinstance(tree, dict):
        return {k: move(v) for k, v in tree.items()}
    return dataclasses.replace(tree, **{f.name: move(getattr(tree, f.name)) for f in dataclasses.fields(tree)})


class _SlotGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, slots):
        ctx.save_for_backward(slots)
        ctx.shape = values.shape
        return values[torch.clamp_min(slots, 0).long()]

    @staticmethod
    def backward(ctx, ct):
        (slots,) = ctx.saved_tensors
        valid = (slots >= 0).reshape(slots.shape + (1,) * (ct.ndim - slots.ndim))
        ct = torch.where(valid, ct, torch.zeros((), dtype=ct.dtype, device=ct.device))
        idx = torch.clamp_min(slots, 0).long().reshape(-1)
        dv = ct.new_zeros(ctx.shape).index_add_(0, idx, ct.reshape((-1,) + tuple(ctx.shape[1:])))
        return dv, None


def slot_gather(values: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Stage per-particle ``values`` (N, ...) onto a slot table ``slots``
    (n_cells, capacity; ``-1`` marks gap and overflow slots), returning
    (n_cells, capacity, ...).

    The forward is the clamp-gather ``values[max(slots, 0)]``: gap slots
    alias particle 0 and the caller's masking keeps its job. The backward
    masks the gap slots out of the scatter-add.

    With a member axis, ``values`` (B, N, ...) and ``slots`` (B, n_cells,
    capacity) of member-local ids give (B, n_cells, capacity, ...): each
    member's slots stage its own values (its gap slots alias its own
    particle 0), in one gather. Only an ensemble bucket's step, which is
    never differentiated, stages with a member axis: its backward is the
    raw indexing's."""
    if slots.dim() > 2:
        b, n = values.shape[:2]
        idx = (torch.clamp_min(slots, 0) + member_offsets(slots, n)).long()
        return values.reshape(b * n, *values.shape[2:])[idx]
    if _tracked(values):
        return _SlotGather.apply(values, slots)
    return values[torch.clamp_min(slots, 0).long()]

"""Recomputation helpers of the reverse pass (no counterpart module in the
reference, whose `jax.checkpoint` and XLA make these choices).

* `recomputed(fn, *tensors)`: ``fn(*tensors)``, whose backward keeps only
  the tensor inputs and recomputes ``fn``'s internals. The bin gather and
  deposition of the ``torch`` route use it: their per-tap weights and
  products would otherwise keep ~180 slot-sized tensors a step for the
  backward, where their inputs are ~12.
* `move_tree(tree, device)`: every tensor of a dataclass moved to
  ``device`` by differentiable copies, so a gradient flows back through
  the move. `run_window_diff` keeps the input state of each checkpointed
  step (or chunk) on the host when the window runs on a card.

Both leave the forward's values bit for bit as they are. Imports only
torch: `core` depends on it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

__all__ = ["move_tree", "recomputed"]


def recomputed(fn, *tensors):
    """``fn(*tensors)``; when autograd records it, through a non-reentrant
    `torch.utils.checkpoint`, which keeps the inputs and runs ``fn`` again
    in the backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return torch.utils.checkpoint.checkpoint(fn, *tensors, use_reentrant=False, preserve_rng_state=False)
    return fn(*tensors)


def move_tree(tree, device):
    """A dataclass of tensors with each tensor moved to ``device`` (a
    differentiable copy; a tensor already there is returned as it is)."""
    return dataclasses.replace(tree, **{f.name: getattr(tree, f.name).to(device) for f in dataclasses.fields(tree)})

"""GPipe pipeline parallelism over a 'pipe' mesh axis whose stages are
stacked on one device. Counterpart of `repro.distributed.pipeline`.

Schedule: M microbatches flow through S stages in M + S - 1 ticks. On each
tick every stage runs ``stage_fn`` on its resident input; stage 0 takes
microbatch t while t < M and zeros after; the last stage writes its result
to output slot t - (S - 1) once that is >= 0; then the stage outputs shift
one stage down (the reference's ``ppermute``, here a shift of the stack)
and stage 0 receives zeros. The bubble fraction is (S-1)/(M+S-1), the
GPipe bound. On one device the stages of a tick run one after another, so
the schedule costs S (M + S - 1) stage calls against the S M of the
sequential composition, whose result it equals. It is differentiable
through autograd.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["pipeline_forward"]


def pipeline_forward(stage_params, microbatches, stage_fn, *, mesh, axis_name: str = "pipe"):
    """Run microbatches through staged layers.

    stage_params: a tree whose every leaf has the stages as its leading dim,
    ``mesh[axis_name]`` of them. microbatches: (M, mb, ...).
    stage_fn(params_slice, x) -> y, the same shape as x.
    Returns the final stage's (M, mb, ...) outputs.
    """
    n_stages = mesh[axis_name]
    n_micro = microbatches.shape[0]
    for leaf in tree_leaves(stage_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(f"a stage parameter of shape {tuple(leaf.shape)} has no leading dim of "
                             f"{n_stages} stages ({axis_name!r})")
    params = [tree_map(lambda a, s=s: a[s], stage_params) for s in range(n_stages)]
    zeros = torch.zeros_like(microbatches[0])
    incoming = [zeros] * n_stages
    outputs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        if t < n_micro:
            incoming[0] = microbatches[t]
        ys = [stage_fn(params[s], incoming[s]) for s in range(n_stages)]
        slot = t - (n_stages - 1)
        if slot >= 0:
            outputs[slot] = ys[-1]
        incoming = [zeros] + ys[:-1]
    return torch.stack(outputs)

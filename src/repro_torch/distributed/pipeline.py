"""GPipe pipeline parallelism over a 'pipe' mesh axis whose stages are
stacked on one device, or spread over ranks. Counterpart of
`repro.distributed.pipeline`.

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

Over ranks (``ranks``, a `distributed.ranks.AxisRanks` on the pipe axis)
a rank holds a contiguous block of the stages and runs them in turn on each
tick; its block's last output crosses to the next rank's first stage
(`AxisRanks.shift`, no wrap: rank 0's first stage takes microbatch t, or
zeros), the last rank writes the output slots, and a broadcast from it
leaves the outputs on every rank, as the reference's masked ``psum`` with
``out_specs=P()`` leaves them replicated. Both collectives are autograd
functions. Every exchange runs its backward on every rank, also where its
output never reaches the result (the zeros rank 0 takes, the last ticks'
sends), since its partner waits in the matching receive: the exchanges and
the broadcast are chained by a 0-d token, so that the result's backward
reaches each of them. For one cotangent held alike on every rank, each
rank's stage-parameter gradient is the stacked run's slice.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["pipeline_forward"]


class _Shift(torch.autograd.Function):
    """A tick's exchange: ``y`` to the next rank, the previous rank's
    ``y`` back (zeros on rank 0); the token passes through. Backwards the
    gradient of what was received goes back to the previous rank, and the
    next rank's comes in as ``y``'s."""

    @staticmethod
    def forward(ctx, y, token, ranks):
        ctx.ranks = ranks
        return ranks.shift(y, 1), token.clone()

    @staticmethod
    def backward(ctx, g_recv, g_token):
        ctx.ranks.counts["shift_backward"] += 1
        return ctx.ranks.shift(g_recv, -1), g_token, None


class _BroadcastLast(torch.autograd.Function):
    """The last rank's outputs on every rank. Backwards a cotangent held
    alike on every rank goes to the last rank's outputs alone, as the
    stacked run takes it once; the token gets zeros, which starts the
    exchanges' chain."""

    @staticmethod
    def forward(ctx, out, token, ranks):
        ctx.ranks = ranks
        ctx.save_for_backward(token)
        return ranks.broadcast_last(out.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        (token,) = ctx.saved_tensors
        return (g if ctx.ranks.is_last else None), torch.zeros_like(token), None


def pipeline_forward(stage_params, microbatches, stage_fn, *, mesh, axis_name: str = "pipe", ranks=None):
    """Run microbatches through staged layers.

    stage_params: a tree whose every leaf has the stages as its leading dim,
    ``mesh[axis_name]`` of them; over ``ranks`` this rank's block of
    ``ranks.n_local``. microbatches: (M, mb, ...), the same on every rank.
    stage_fn(params_slice, x) -> y, the same shape as x.
    Returns the final stage's (M, mb, ...) outputs (on every rank).
    """
    n_stages = mesh[axis_name]
    n_local = n_stages if ranks is None else ranks.n_local
    if ranks is not None and ranks.n != n_stages:
        raise ValueError(f"the ranks hold {ranks.n} stages along {ranks.axis!r}, the mesh {n_stages} ({axis_name!r})")
    n_micro = microbatches.shape[0]
    for leaf in tree_leaves(stage_params):
        if leaf.shape[0] != n_local:
            raise ValueError(f"a stage parameter of shape {tuple(leaf.shape)} has no leading dim of "
                             f"{n_local} stages ({axis_name!r})")
    params = [tree_map(lambda a, s=s: a[s], stage_params) for s in range(n_local)]
    zeros = torch.zeros_like(microbatches[0])
    if ranks is None:
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

    grad = torch.is_grad_enabled() and any(a.requires_grad for a in tree_leaves(stage_params) + [microbatches])
    token = torch.zeros((), device=zeros.device, requires_grad=grad)
    ticks = n_micro + n_stages - 1
    incoming = [zeros] * n_local
    outputs = []
    for t in range(ticks):
        if ranks.rank == 0 and t < n_micro:
            incoming[0] = microbatches[t]
        ys = [stage_fn(params[s], incoming[s]) for s in range(n_local)]
        if ranks.is_last and t >= n_stages - 1:
            outputs.append(ys[-1])
        if t < ticks - 1:
            received, token = _Shift.apply(ys[-1], token, ranks)
            incoming = [received] + ys[:-1]
    out = torch.stack(outputs) if ranks.is_last else torch.zeros((n_micro,) + tuple(zeros.shape), dtype=zeros.dtype,
                                                                  device=zeros.device)
    return _BroadcastLast.apply(out, token, ranks)

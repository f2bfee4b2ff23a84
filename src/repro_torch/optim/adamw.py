"""AdamW with decoupled weight decay, global-norm clipping and float32
moments. Counterpart of `repro.optim.adamw`.

Plain functions over (nested) dicts of tensors, with the reference's math
and order: the gradients are clipped by their global norm first, the
moments are kept in float32 whatever the parameters' dtype, the bias
correction uses the state's ``count``, and the update is computed in
float32 and cast back. Not `torch.optim.AdamW`, whose clipping and step
order differ: a fit's trajectory is held to the reference's.

`adamw_update_` writes the update into the parameters and moments in
place: the LM train step uses it, because a full-width model cannot hold a
second copy of its parameters and float32 moments beside the first.
`adamw_update` runs it on copies and returns new parameters and moments,
as the reference does; `grad.fit` uses it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["AdamWConfig", "ScheduleConfig", "adamw_init", "adamw_update", "adamw_update_", "clip_by_global_norm",
           "global_norm", "lr_schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, tuples and lists, dict keys in
    sorted order (the reference's pytree order)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = _leaves(params)[0].device
    return {"mu": _map(zeros, params), "nu": _map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, *, cuts=()) -> torch.Tensor:
    """The float32 norm of every leaf. Over ranks (``cuts``: a pair for
    each mesh axis, in the order summed, of its collectives, a
    `distributed.fsdp.FSDP` or `distributed.tensor_parallel.TensorParallel`,
    and flags in leaf order, True where the leaf is this rank's block of a
    leaf cut over that axis) each cut leaf's sum of squares is its block's,
    and the blocks' sums are added over the axis's ranks in rank order
    (`sum`, counted as ``norm``, one gather an axis for all of them). A
    leaf cut over two axes is so counted once, and a leaf cut over none
    counts once as it is. Each leaf is summed in its logical order whatever
    its strides (a gradient autograd gives strided sums as its contiguous
    copy does, which the rank paths reduce)."""
    squares = [torch.sum(torch.square(g.reshape(-1).to(torch.float32))) for g in _leaves(tree)]
    for ranks, flags in cuts:
        cut = [i for i, s in enumerate(flags) if s]
        if cut:
            total = ranks.sum(torch.stack([squares[i] for i in cut]), "norm")
            for j, i in enumerate(cut):
                squares[i] = total[j]
    return torch.sqrt(sum(squares))


def _clip_scale(norm, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


def _clip(g, scale) -> torch.Tensor:
    return (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float, *, cuts=()):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping); ``cuts``: `global_norm`'s."""
    norm = global_norm(grads, cuts=cuts)
    scale = _clip_scale(norm, max_norm)
    return _map(lambda g: _clip(g, scale), grads), norm


def adamw_update(grads, state: dict, params, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state, metrics): `adamw_update_` on copies
    of ``params`` and ``state``, which are left as they were."""
    copy = lambda t: t.detach().clone(memory_format=torch.contiguous_format)  # noqa: E731
    params = _map(copy, params)
    state = {"mu": _map(copy, state["mu"]), "nu": _map(copy, state["nu"]), "count": copy(state["count"])}
    metrics = adamw_update_(grads, state, params, cfg, lr_scale)
    return params, state, metrics


# elements of a leaf updated at a time by `adamw_update_`: bounds its float32
# temporaries (elementwise arithmetic, so the slices change no bit)
_CHUNK = 1 << 24


def adamw_update_(grads, state: dict, params, cfg: AdamWConfig, lr_scale=1.0, *, cuts=()) -> dict:
    """One AdamW step in the reference's arithmetic and order, written into
    ``params``, ``state["mu"]``, ``state["nu"]`` and ``state["count"]``.
    The clip by the global norm is applied a slice at a time as the slice
    is updated, so no clipped copy of the gradients is made. Over ranks
    (``cuts``: `global_norm`'s) each rank updates its blocks, elementwise.
    Returns the metrics."""
    with torch.no_grad():
        gnorm = global_norm(grads, cuts=cuts)
        scale = _clip_scale(gnorm, cfg.grad_clip)
        state["count"].add_(1)
        count = state["count"]
        b1c = 1.0 - cfg.b1 ** count.to(torch.float32)
        b2c = 1.0 - cfg.b2 ** count.to(torch.float32)
        lr = cfg.lr * lr_scale
        for p, g, mu, nu in zip(_leaves(params), _leaves(grads), _leaves(state["mu"]), _leaves(state["nu"])):
            # the state's tensors are written through flat views; a gradient
            # may come out of autograd strided, and is flattened (copied) then
            p, mu, nu = (t.view(-1) for t in (p, mu, nu))
            g = g.reshape(-1)
            for i in range(0, p.numel(), _CHUNK):
                sl = slice(i, i + _CHUNK)
                _upd_(p[sl], _clip(g[sl], scale), mu[sl], nu[sl], cfg, b1c, b2c, lr)
    return {"grad_norm": gnorm}


def _upd_(p, g, mu, nu, cfg: AdamWConfig, b1c, b2c, lr) -> None:
    """The update of one slice, into ``p``, ``mu``, ``nu``: ``mu`` and
    ``nu`` are the moving averages of ``g`` and ``g**2``, and ``p`` moves by
    ``lr`` times the bias-corrected ``mu / (sqrt(nu) + eps)`` plus the
    decoupled weight decay, computed in float32 and cast back."""
    g32 = g.to(torch.float32)
    mu.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
    nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
    del g32
    step = mu / b1c
    den = torch.sqrt(nu / b2c).add_(cfg.eps)
    step.div_(den)
    del den
    step.add_(cfg.weight_decay * p.to(torch.float32))
    step.mul_(lr)
    p.copy_(p.to(torch.float32) - step)


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    warmup_steps: int = 100
    total_steps: int = 10000
    min_ratio: float = 0.1


def lr_schedule(step, cfg: ScheduleConfig) -> torch.Tensor:
    """Linear warmup + cosine decay to min_ratio (a scale in [0, 1])."""
    step = step.to(torch.float32) if isinstance(step, torch.Tensor) else torch.tensor(float(step))
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_ratio + (1 - cfg.min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos

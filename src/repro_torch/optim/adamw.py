"""AdamW with decoupled weight decay, global-norm clipping and float32
moments. Counterpart of `repro.optim.adamw`.

Plain functions over (nested) dicts of tensors, with the reference's math
and order: the gradients are clipped by their global norm first, the
moments are kept in float32 whatever the parameters' dtype, the bias
correction uses the state's ``count``, and the update is computed in
float32 and cast back. Not `torch.optim.AdamW`, whose clipping and step
order differ: a fit's trajectory is held to the reference's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["AdamWConfig", "ScheduleConfig", "adamw_init", "adamw_update", "clip_by_global_norm", "global_norm",
           "lr_schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, keys in sorted order (the
    reference's pytree order)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = _leaves(params)[0].device
    return {"mu": _map(zeros, params), "nu": _map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in _leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return _map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def adamw_update(grads, state: dict, params, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    count = state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** count.to(torch.float32)
    lr = cfg.lr * lr_scale

    def upd(p, g, mu, nu):
        g32 = g.to(torch.float32)
        mu = cfg.b1 * mu + (1 - cfg.b1) * g32
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g32)
        mhat = mu / b1c
        nhat = nu / b2c
        step = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype), mu, nu

    with torch.no_grad():
        out = _map(upd, params, grads, state["mu"], state["nu"])
    pick = lambda i: _map(lambda o: o[i], out) if isinstance(out, dict) else out[i]
    return pick(0), {"mu": pick(1), "nu": pick(2), "count": count}, {"grad_norm": gnorm}


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

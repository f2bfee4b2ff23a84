"""Relativistic Boris particle pusher. Counterpart of `repro.pic.pusher`.

Momentum u = gamma * v in units of c; q_over_m is the charge-to-mass ratio
in normalized units (electron: -1).
"""

from __future__ import annotations

import torch


def _row(values, like: torch.Tensor) -> torch.Tensor:
    """A small constant vector on ``like``'s device, made by fill kernels: a
    host-to-device copy from pageable memory would wait for the stream."""
    return torch.stack([torch.full((), float(v), dtype=like.dtype, device=like.device) for v in values])


def lorentz_gamma(u: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(1.0 + torch.sum(u * u, dim=-1))


def boris_push(u, e, b, q_over_m: float, dt: float) -> torch.Tensor:
    """One Boris rotation. u, e, b: (Np, 3). Returns u^{n+1/2}."""
    h = 0.5 * dt * q_over_m
    u_minus = u + h * e
    gamma = lorentz_gamma(u_minus)
    t = h * b / gamma[..., None]
    t2 = torch.sum(t * t, dim=-1, keepdim=True)
    u_prime = u_minus + torch.linalg.cross(u_minus, t, dim=-1)
    s = 2.0 * t / (1.0 + t2)
    u_plus = u_minus + torch.linalg.cross(u_prime, s, dim=-1)
    return u_plus + h * e


def advance_positions(pos, u, dt: float, dx) -> torch.Tensor:
    """pos in grid units; u relativistic momentum. Returns new pos."""
    gamma = lorentz_gamma(u)
    v = u / gamma[..., None]
    return pos + dt * v * _row([1.0 / d for d in dx], pos)


def wrap_periodic(pos, grid_shape) -> torch.Tensor:
    """Periodic wrap into [0, n) per axis: `torch.remainder` (the sign of the
    divisor, as `jnp.mod`), never `torch.fmod`. A tiny negative position can
    round to exactly n; `binning.cell_index` clips it into the last cell."""
    return torch.remainder(pos, _row(grid_shape, pos))

"""Registry of differentiable physics objectives. Counterpart of
`repro.grad.objectives`.

An objective is a scalar function of the final window state (and the
window's bundle) that `grad.fit` differentiates through the whole run:

    @register_objective("my_loss", maximize=True)
    def my_loss(state, bundle, config, **kwargs) -> torch.Tensor: ...

Conventions, as in the reference:

* reductions run in the state's own dtype (float64 under the
  finite-difference tests), never on the bundle's float32 diagnostics;
* hard counts are smoothed: `injected_charge` gates on a sigmoid of the
  kinetic energy, so the objective and its gradient are continuous in the
  laser and plasma parameters;
* ``maximize=True`` objectives are negated by the fit loop; the registry
  records the sign so that the CLI reports the physical quantity.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.pic.pusher import lorentz_gamma

__all__ = ["Objective", "get_objective", "objective_names", "register_objective"]


@dataclasses.dataclass(frozen=True)
class Objective:
    name: str
    fn: Callable
    maximize: bool
    doc: str


_OBJECTIVES: dict[str, Objective] = {}


def register_objective(name: str, *, maximize: bool = True):
    """Register ``fn(state, bundle, config, **kwargs) -> scalar`` under
    ``name``; ``maximize`` records the sense (the fit minimizes ``-fn``)."""

    def deco(fn: Callable):
        doc = (fn.__doc__ or "").strip().split("\n")[0]
        _OBJECTIVES[name] = Objective(name=name, fn=fn, maximize=maximize, doc=doc)
        return fn

    return deco


def objective_names() -> list[str]:
    return sorted(_OBJECTIVES)


def get_objective(name: str) -> Objective:
    if name not in _OBJECTIVES:
        raise KeyError(f"unknown objective {name!r}; registered: {objective_names()}")
    return _OBJECTIVES[name]


# -- shipped objectives ------------------------------------------------------------


def _gate(state, e_min, width):
    """Soft indicator of energetic particles: a sigmoid of the kinetic
    energy (gamma - 1) above ``e_min``, of softness ``width``."""
    gamma = lorentz_gamma(state.particles.u)
    return torch.sigmoid(((gamma - 1.0) - e_min) / width), gamma


@register_objective("injected_charge", maximize=True)
def injected_charge(state, bundle, config, *, e_min: float = 0.5, width: float = 0.1):
    """Charge trapped above the energy cut: sum of |q| * w over alive
    particles, sigmoid-gated on kinetic energy (gamma - 1) > e_min."""
    p = state.particles
    gate, _ = _gate(state, e_min, width)
    alive = p.alive.to(p.w.dtype)
    q = torch.abs(torch.tensor(config.charge, dtype=p.w.dtype, device=p.w.device))
    return torch.sum(q * p.w * alive * gate)


@register_objective("mean_beam_energy", maximize=True)
def mean_beam_energy(state, bundle, config, *, e_min: float = 0.5, width: float = 0.1):
    """Charge-weighted mean kinetic energy (gamma - 1) of the gated beam."""
    p = state.particles
    gate, gamma = _gate(state, e_min, width)
    wgt = p.w * p.alive.to(p.w.dtype) * gate
    return torch.sum(wgt * (gamma - 1.0)) / (torch.sum(wgt) + 1e-9)


@register_objective("field_energy_band", maximize=True)
def field_energy_band(state, bundle, config, *, z0: float = 0.0, z1: float | None = None):
    """EM field energy (0.5 * sum(E^2 + B^2) * cell volume) inside the
    z-slab [z0, z1) in grid units; z1=None means the box end."""
    f = state.fields
    nz = config.grid.shape[2]
    hi = nz if z1 is None else z1
    z = torch.arange(nz, device=f.ex.device)
    mask = ((z >= z0) & (z < hi)).to(f.ex.dtype)
    em = sum(0.5 * torch.sum((comp * comp) * mask[None, None, :]) for comp in f.all())
    return em * config.grid.cell_volume

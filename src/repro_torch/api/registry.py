"""Scenario registry: named builders of default `SimSpec`s. Counterpart of
`repro.api.registry` for the ``uniform`` and ``lwfa`` scenarios, with the
same defaults and the same flat override vocabulary for the spec nodes the
port has.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.api.spec import PerturbSpec, PlasmaSpec, ProfileSpec, RunSpec, SimSpec, SortSpec
from repro_torch.pic.grid import GridSpec
from repro_torch.pic.laser import LaserSpec

__all__ = ["apply_overrides", "register_scenario", "scenario", "scenario_names"]

_SCENARIOS: dict[str, Callable[[dict], SimSpec]] = {}


def register_scenario(name: str):
    """Register ``fn(overrides: dict) -> SimSpec`` as a named scenario
    builder; it may pop structural overrides (``grid``)."""

    def deco(fn: Callable[[dict], SimSpec]):
        _SCENARIOS[name] = fn
        return fn

    return deco


def scenario_names() -> list[str]:
    return sorted(_SCENARIOS)


def scenario(name: str, **overrides) -> SimSpec:
    """Build the named scenario's `SimSpec` with flat keyword overrides."""
    if name not in _SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; registered: {scenario_names()}")
    spec = _SCENARIOS[name](overrides)
    return apply_overrides(spec, **overrides)


# flat override name -> path into the spec tree
_OVERRIDE_PATHS = {
    "steps": ("run", "steps"),
    "window": ("run", "window"),
    "diagnostics_every": ("run", "diagnostics_every"),
    "dt": ("run", "dt"),
    "cfl_safety": ("run", "cfl_safety"),
    "order": ("deposition", "order"),
    "deposition": ("deposition", "mode"),
    "backend": ("deposition", "backend"),
    "gather": ("deposition", "gather"),
    "sort": ("sort", "mode"),
    "capacity": ("sort", "capacity"),
    "policy": ("sort", "policy"),
    "ppc": ("plasma", "ppc_each_dim"),
    "ppc_each_dim": ("plasma", "ppc_each_dim"),
    "density": ("plasma", "density"),
    "u_thermal": ("plasma", "u_thermal"),
    "jitter": ("plasma", "jitter"),
    "seed": ("plasma", "seed"),
    "profile": ("plasma", "profile"),
    "drift": ("plasma", "drift"),
    "perturb": ("plasma", "perturb"),
    "name": ("name",),
    "charge": ("charge",),
    "mass": ("mass",),
    "ckc_beta": ("ckc_beta",),
    "laser": ("laser",),
    "grid": ("grid",),
}


def apply_overrides(spec: SimSpec, **overrides) -> SimSpec:
    """Route flat override names into the spec tree (``order=2`` ->
    ``spec.deposition.order``). ``ppc`` accepts an int (cubed) or a
    3-tuple; ``grid`` a shape 3-tuple (keeps the spec's dx) or a GridSpec."""
    by_section: dict[str, dict] = {}
    top: dict = {}
    for key, value in overrides.items():
        if key not in _OVERRIDE_PATHS:
            raise TypeError(f"unknown scenario override {key!r}; known: {sorted(_OVERRIDE_PATHS)}")
        path = _OVERRIDE_PATHS[key]
        if key in ("ppc", "ppc_each_dim") and isinstance(value, int):
            value = (value, value, value)
        if key == "grid" and not isinstance(value, GridSpec):
            value = GridSpec(shape=tuple(int(v) for v in value), dx=spec.grid.dx)
        if len(path) == 1:
            top[path[0]] = value
        else:
            by_section.setdefault(path[0], {})[path[1]] = value
    for section, kw in by_section.items():
        top[section] = dataclasses.replace(getattr(spec, section), **kw)
    return dataclasses.replace(spec, **top) if top else spec


def _pop_grid(ov: dict, default_shape, dx=(1.0, 1.0, 1.0)) -> GridSpec:
    g = ov.pop("grid", default_shape)
    if isinstance(g, GridSpec):
        return g
    return GridSpec(shape=tuple(int(v) for v in g), dx=dx)


@register_scenario("uniform")
def _uniform(ov: dict) -> SimSpec:
    """Warm uniform plasma with a Langmuir velocity seed."""
    grid = _pop_grid(ov, (16, 16, 16))
    return SimSpec(
        name="uniform",
        grid=grid,
        plasma=PlasmaSpec(
            ppc_each_dim=(2, 2, 2),
            u_thermal=0.02,
            perturb=PerturbSpec(v_axis=0, amplitude=0.01, mode=1),
        ),
        run=RunSpec(steps=50, window=16),
    )


@register_scenario("lwfa")
def _lwfa(ov: dict) -> SimSpec:
    """Laser-wakefield acceleration: gaussian pulse into a density step; the
    density onset and pulse center scale with the box length."""
    grid = _pop_grid(ov, (8, 8, 64))
    nz = grid.shape[2]
    return SimSpec(
        name="lwfa",
        grid=grid,
        plasma=PlasmaSpec(
            ppc_each_dim=(2, 2, 2),
            u_thermal=0.01,
            profile=ProfileSpec(kind="step", z_on=nz * 0.3),
        ),
        laser=LaserSpec(a0=2.0, wavelength=8.0, waist=6.0, duration=8.0, z_center=nz * 0.15),
        sort=SortSpec(capacity=48),
        run=RunSpec(steps=60, window=10, dt=0.35),
    )

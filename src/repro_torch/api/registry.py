"""Scenario registry: named builders of default `SimSpec`s. Counterpart of
`repro.api.registry`, with the same scenarios, defaults and flat override
vocabulary:

* ``uniform``     thermal plasma + Langmuir velocity seed;
* ``lwfa``        laser-wakefield acceleration: gaussian pulse + density step;
* ``two_stream``  symmetric cold counter-streaming beams along z with the
                  fastest-growing longitudinal mode seeded
                  (`two_stream_growth_rate`, `two_stream_linear_energy`);
* ``weibel``      counter-streaming beams along x with a transverse (k along
                  z) filamentation seed (`weibel_growth_rate`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from repro_torch.api.spec import (
    CommSpec,
    DriftSpec,
    FaultSpec,
    HealthConfig,
    PerturbSpec,
    PlasmaSpec,
    ProfileSpec,
    RunSpec,
    SimSpec,
    SortSpec,
)
from repro_torch.pic.grid import GridSpec
from repro_torch.pic.laser import LaserSpec

__all__ = [
    "apply_overrides",
    "register_scenario",
    "scenario",
    "scenario_names",
    "two_stream_growth_rate",
    "two_stream_linear_energy",
    "weibel_growth_rate",
]

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
    "autosave_every": ("run", "autosave_every"),
    "autosave_path": ("run", "autosave_path"),
    "health": ("health",),
    "fault": ("fault",),
    "comm": ("comm",),
    "overlap_halo": ("comm", "overlap_halo"),
    "compress_migration": ("comm", "compress_migration"),
    "rebalance_enable": ("comm", "rebalance_enable"),
    "imbalance_ratio": ("comm", "imbalance_ratio"),
    "order": ("deposition", "order"),
    "deposition": ("deposition", "mode"),
    "use_pallas": ("deposition", "use_pallas"),
    "backend": ("deposition", "backend"),
    "gather": ("deposition", "gather"),
    "sort": ("sort", "mode"),
    "capacity": ("sort", "capacity"),
    "policy": ("sort", "policy"),
    "mesh": ("mesh", "shape"),
    "mig_cap": ("mesh", "mig_cap"),
    "n_local": ("mesh", "n_local"),
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
    3-tuple; ``grid`` a shape 3-tuple (keeps the spec's dx) or a GridSpec;
    ``drift`` a DriftSpec or a number, the drift speed along the spec's
    drift axis (a sweep's ``drift=0.1,0.2``; the reference stores the bare
    number, which its `build_particles` cannot read)."""
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
        if key == "health" and isinstance(value, dict):
            value = HealthConfig.from_dict(value)
        if key == "fault" and isinstance(value, dict):
            value = FaultSpec.from_dict(value)
        if key == "comm" and isinstance(value, dict):
            value = CommSpec.from_dict(value)
        if key == "drift" and isinstance(value, (int, float)):
            value = DriftSpec(u=float(value), axis=(spec.plasma.drift or DriftSpec()).axis)
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


@register_scenario("two_stream")
def _two_stream(ov: dict) -> SimSpec:
    """Symmetric cold two-stream instability along z. The box resolves the
    plasma wavelength (dz = 0.125 c/omega_p) and the seeded mode sits at
    the fastest-growing wavenumber k v0 ~ sqrt(3)/2 * omega_b."""
    grid = _pop_grid(ov, (4, 4, 64), dx=(1.0, 1.0, 0.125))
    return SimSpec(
        name="two_stream",
        grid=grid,
        plasma=PlasmaSpec(
            ppc_each_dim=(1, 1, 4),
            u_thermal=0.0,
            drift=DriftSpec(u=0.2, axis=2),
            perturb=PerturbSpec(v_axis=2, amplitude=1e-3, mode=4),
        ),
        run=RunSpec(steps=300, window=25, diagnostics_every=1),
    )


@register_scenario("weibel")
def _weibel(ov: dict) -> SimSpec:
    """Weibel/filamentation instability: counter-streams along x, seeded
    transverse mode with k along z; magnetic field growth at
    gamma ~ beta * omega_p."""
    grid = _pop_grid(ov, (4, 4, 64), dx=(1.0, 1.0, 0.25))
    return SimSpec(
        name="weibel",
        grid=grid,
        plasma=PlasmaSpec(
            ppc_each_dim=(1, 1, 4),
            u_thermal=0.0,
            drift=DriftSpec(u=0.3, axis=0),
            perturb=PerturbSpec(v_axis=0, amplitude=1e-3, mode=8, k_axis=2),
        ),
        run=RunSpec(steps=260, window=20, diagnostics_every=1),
    )


# -- analytic growth rates (the scenarios' physics anchors) -------------------


def _seeded_k(spec: SimSpec) -> float:
    """Physical wavenumber of the seeded perturbation mode."""
    p = spec.plasma.perturb
    k_axis = p.v_axis if p.k_axis < 0 else p.k_axis
    length = spec.grid.shape[k_axis] * spec.grid.dx[k_axis]
    return 2.0 * math.pi * p.mode / length


def two_stream_growth_rate(spec: SimSpec) -> float:
    """Cold symmetric two-stream amplitude growth rate (1/time) at the
    seeded mode, from 1 = omega_b^2 [(w-kv)^-2 + (w+kv)^-2] with the
    relativistic longitudinal mass correction omega_b^2 -> omega_b^2 /
    gamma0^3. Field energy grows at twice this rate."""
    u0 = spec.plasma.drift.u
    gamma0 = math.sqrt(1.0 + u0 * u0)
    v0 = u0 / gamma0
    wb2 = 0.5 * spec.plasma.density / gamma0**3  # per-beam plasma frequency^2
    a = (_seeded_k(spec) * v0) ** 2 / wb2        # kappa^2, in omega_b units
    y2 = -(a + 1.0) + math.sqrt(4.0 * a + 1.0)   # y^2 from y^4+2y^2(a+1)+a^2-2a=0
    if y2 <= 0.0:
        return 0.0
    return math.sqrt(wb2 * y2)


def two_stream_linear_energy(spec: SimSpec, steps) -> np.ndarray:
    """Field energy after each of ``steps`` from the cold linearised
    two-beam equations of `two_stream_growth_rate`, solved as an
    initial-value problem for the spec's own seed, with all four roots of
    its dispersion relation: two beams of density n/2 at +-v0 with
    longitudinal mass gamma0^3, u along the drift seeded with A sin(kz), no
    initial field. W = V |E_k|^2 / 4 for the field E_k sin(kz) over the
    box's volume V. A velocity seed is not the growing eigenmode: the field
    energy oscillates with the stable roots until the growing one rules,
    which at a weak drift is late in a run."""
    p, g = spec.plasma, spec.grid
    g0 = math.sqrt(1.0 + p.drift.u * p.drift.u)
    v0, mass, half = p.drift.u / g0, g0**3, 0.5 * p.density
    k = _seeded_k(spec)
    a = np.zeros((5, 5), complex)  # (dn+, dv+, dn-, dv-, E_k), electrons
    for s, v in ((0, v0), (2, -v0)):
        a[s, s] = a[s + 1, s + 1] = -1j * k * v
        a[s, s + 1] = -1j * k * half
        a[s + 1, 4] = -1.0 / mass
        a[4, s], a[4, s + 1] = v, half
    dv = p.perturb.amplitude / mass
    lam, vec = np.linalg.eig(a)
    weights = vec[4] * np.linalg.solve(vec, np.array([0.0, dv, 0.0, dv, 0.0], complex))
    e_k = weights @ np.exp(np.outer(lam, np.asarray(steps, dtype=float) * spec.dt))
    return math.prod(n * d for n, d in zip(g.shape, g.dx)) / 4.0 * np.abs(e_k) ** 2


def weibel_growth_rate(spec: SimSpec) -> float:
    """Cold symmetric filamentation amplitude growth rate (1/time) at the
    seeded transverse mode: gamma^2 is the positive root of
    gamma^4 + gamma^2 (k^2 c^2 + omega_p^2) - omega_p^2 k^2 beta^2 = 0
    (relativistic transverse mass: omega_p^2 -> omega_p^2/gamma0)."""
    u0 = spec.plasma.drift.u
    gamma0 = math.sqrt(1.0 + u0 * u0)
    beta = u0 / gamma0
    wp2 = spec.plasma.density / gamma0
    k2 = _seeded_k(spec) ** 2
    s = k2 + wp2
    g2 = 0.5 * (-s + math.sqrt(s * s + 4.0 * wp2 * k2 * beta * beta))
    return math.sqrt(max(g2, 0.0))

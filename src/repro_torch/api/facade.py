"""The driver facade: spec -> initial conditions -> `Simulation`, and the
checkpoints (`save_simulation`, `restore_simulation`, `load_simulation`,
from `repro_torch.checkpoint`). Counterpart of the single-device part of
`repro.api.facade`.

Entry points run on ``cuda`` unless the caller names another device; with
no CUDA device and no device named they raise, never falling back to the
CPU.
"""

from __future__ import annotations

import torch

from repro_torch.api.spec import SimSpec
from repro_torch.checkpoint import load_simulation, restore_simulation, save_simulation
from repro_torch.pic.grid import FieldState
from repro_torch.pic.laser import inject_laser
from repro_torch.pic.plasma import ParticleState, apply_counter_drift, perturb_velocity, profiled_plasma, uniform_plasma

__all__ = [
    "build_fields",
    "build_particles",
    "load_simulation",
    "make_simulation",
    "pic_config",
    "resolve_device",
    "restore_simulation",
    "save_simulation",
]


def resolve_device(device=None) -> torch.device:
    """``device`` as a `torch.device`; None means ``cuda``, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def build_particles(spec: SimSpec, *, device=None) -> ParticleState:
    """PlasmaSpec -> ParticleState: lattice base (uniform or profiled), then
    counter-streaming drift, then the velocity seed. Random numbers come
    from a CPU generator seeded with ``spec.plasma.seed``."""
    device = resolve_device(device)
    p = spec.plasma
    gen = torch.Generator().manual_seed(p.seed)
    if p.profile is not None:
        z_on, density = p.profile.z_on, p.density
        parts = profiled_plasma(
            gen, spec.grid, ppc_each_dim=p.ppc_each_dim,
            density_fn=lambda z: torch.where(z > z_on, density, 0.0),
            u_thermal=p.u_thermal, jitter=p.jitter, device=device,
        )
    else:
        parts = uniform_plasma(
            gen, spec.grid, ppc_each_dim=p.ppc_each_dim, density=p.density,
            u_thermal=p.u_thermal, jitter=p.jitter, device=device,
        )
    if p.drift is not None:
        parts = apply_counter_drift(parts, u_drift=p.drift.u, axis=p.drift.axis)
    if p.perturb is not None:
        pe = p.perturb
        parts = perturb_velocity(
            parts, axis=pe.v_axis, amplitude=pe.amplitude, mode=pe.mode,
            grid=spec.grid, k_axis=None if pe.k_axis < 0 else pe.k_axis,
        )
    return parts


def build_fields(spec: SimSpec, *, device=None) -> FieldState:
    """Zero fields, plus the laser pulse when the spec names one."""
    fields = FieldState.zeros(spec.grid.shape, device=resolve_device(device))
    if spec.laser is not None:
        fields = inject_laser(fields, spec.grid, spec.laser)
    return fields


def pic_config(spec: SimSpec):
    """Derive the single-device `PICConfig` from a spec."""
    from repro_torch.pic.simulation import PICConfig

    d = spec.deposition
    return PICConfig(
        grid=spec.grid,
        dt=spec.dt,
        order=d.order,
        deposition=d.mode,
        gather=d.resolved_gather,
        sort_mode=spec.sort.mode,
        charge=spec.charge,
        mass=spec.mass,
        ckc_beta=spec.ckc_beta,
        capacity=spec.sort.resolved_capacity(spec.plasma.ppc),
        backend=d.backend,
    )


def make_simulation(spec: SimSpec, *, fields: FieldState | None = None,
                    particles: ParticleState | None = None, device=None):
    """Build the single-device `Simulation` a spec describes, on
    ``device`` (default ``cuda``). ``fields``/``particles`` replace the
    spec-built initial conditions and move to the device."""
    from repro_torch.pic.simulation import Simulation

    device = resolve_device(device)
    fields = build_fields(spec, device=device) if fields is None else FieldState(*(f.to(device) for f in fields.all()))
    particles = build_particles(spec, device=device) if particles is None else particles.to(device)
    return Simulation(fields, particles, pic_config(spec), policy=spec.sort.policy, spec=spec)

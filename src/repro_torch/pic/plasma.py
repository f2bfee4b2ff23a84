"""Particle initialization: uniform and profiled plasma, counter-streaming
drift, velocity seed. Counterpart of `repro.pic.plasma`.

Random numbers come from a seeded CPU `torch.Generator` and the arrays move
to the target device afterwards, so one seed gives the same particles on
every device. They are not the reference's `jax.random` numbers: tests that
compare the two packages build particles with numpy and hand them to both.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.pic.grid import GridSpec


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """SoA particle container (single species; constants live in the config)."""

    pos: torch.Tensor    # (Np, 3) grid units
    u: torch.Tensor      # (Np, 3) relativistic momentum / c
    w: torch.Tensor      # (Np,) macro-particle weight
    alive: torch.Tensor  # (Np,) bool

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def to(self, device) -> "ParticleState":
        return ParticleState(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def _lattice_in_cell(ppc_each_dim) -> torch.Tensor:
    """Evenly spaced sub-cell offsets, (prod(ppc), 3)."""
    axes = [(torch.arange(p, dtype=torch.float32) + 0.5) / p for p in ppc_each_dim]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)


def uniform_plasma(generator: torch.Generator, grid: GridSpec, *, ppc_each_dim=(2, 2, 2), density: float = 1.0,
                   u_thermal: float = 0.0, jitter: float = 0.0, device=None) -> ParticleState:
    """Uniform plasma filling the box; weights make the deposited number
    density equal `density`."""
    nx, ny, nz = grid.shape
    offsets = _lattice_in_cell(ppc_each_dim)
    ppc = offsets.shape[0]
    cx, cy, cz = torch.meshgrid(torch.arange(nx), torch.arange(ny), torch.arange(nz), indexing="ij")
    cells = torch.stack([cx, cy, cz], dim=-1).reshape(-1, 1, 3).to(torch.float32)
    pos = (cells + offsets[None]).reshape(-1, 3)
    n = pos.shape[0]
    if jitter > 0:
        ppc_t = torch.tensor([float(p) for p in ppc_each_dim])
        pos = pos + jitter * (torch.rand(pos.shape, generator=generator) - 0.5) / ppc_t
        pos = torch.remainder(pos, torch.tensor([float(s) for s in grid.shape]))
    u = u_thermal * torch.randn((n, 3), generator=generator) if u_thermal > 0 else torch.zeros((n, 3))
    w = torch.full((n,), density * grid.cell_volume / ppc, dtype=torch.float32)
    return ParticleState(pos=pos, u=u, w=w, alive=torch.ones(n, dtype=torch.bool)).to(device)


def profiled_plasma(generator: torch.Generator, grid: GridSpec, *, ppc_each_dim=(1, 1, 1), density_fn,
                    u_thermal: float = 0.0, jitter: float = 0.0, device=None) -> ParticleState:
    """Plasma with a z-dependent density profile: weights scaled by
    density_fn(z in grid units); zero-weight particles are dead."""
    base = uniform_plasma(generator, grid, ppc_each_dim=ppc_each_dim, density=1.0, u_thermal=u_thermal,
                          jitter=jitter, device=device)
    w = base.w * density_fn(base.pos[:, 2]).to(torch.float32)
    return dataclasses.replace(base, w=w, alive=w > 0)


def apply_counter_drift(particles: ParticleState, *, u_drift: float, axis: int) -> ParticleState:
    """Two symmetric counter-streaming beams: particles alternate between the
    +/-`u_drift` beams by index."""
    idx = torch.arange(particles.n, device=particles.u.device)
    sign = torch.where(idx % 2 == 0, 1.0, -1.0).to(particles.u.dtype)
    u = particles.u.clone()
    u[:, axis] += sign * u_drift
    return dataclasses.replace(particles, u=u)


def counter_streaming_plasma(generator: torch.Generator, grid: GridSpec, *, ppc_each_dim=(2, 2, 2),
                             density: float = 1.0, u_drift: float = 0.2, drift_axis: int = 2,
                             u_thermal: float = 0.0, device=None) -> ParticleState:
    """Uniform plasma split into two symmetric counter-streaming beams
    (total density `density`): the two-stream (drift along the wave vector)
    and Weibel (drift transverse to it) unstable equilibria. See
    `apply_counter_drift`."""
    base = uniform_plasma(generator, grid, ppc_each_dim=ppc_each_dim, density=density, u_thermal=u_thermal,
                          device=device)
    return apply_counter_drift(base, u_drift=u_drift, axis=drift_axis)


def perturb_velocity(particles: ParticleState, *, axis: int, amplitude: float, mode: int, grid: GridSpec,
                     k_axis: int | None = None) -> ParticleState:
    """u[axis] += A*sin(k x[k_axis]), k the `mode`-th harmonic of the box."""
    k_axis = axis if k_axis is None else k_axis
    k = 2.0 * math.pi * mode / grid.shape[k_axis]
    du = amplitude * torch.sin(k * particles.pos[:, k_axis])
    u = particles.u.clone()
    u[:, axis] += du
    return dataclasses.replace(particles, u=u)

"""Gaussian laser pulse initialization for LWFA workloads. Counterpart of
`repro.pic.laser`: a pulse inside the box propagating toward +z with Ex
polarization (plane-wave pairing By = Ex)."""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.pic.grid import FieldState, GridSpec


@dataclasses.dataclass(frozen=True)
class LaserSpec:
    a0: float = 2.0            # normalized vector potential amplitude
    wavelength: float = 8.0    # in grid units (>= ~8 cells for resolution)
    waist: float = 16.0        # transverse 1/e radius, grid units
    duration: float = 12.0     # longitudinal 1/e half-length, grid units
    z_center: float = 24.0     # initial pulse center, grid units


def inject_laser(fields: FieldState, grid: GridSpec, spec: LaserSpec, *, a0=None, waist=None,
                 duration=None) -> FieldState:
    """Add the pulse the spec describes to ``fields``, in the fields' dtype.

    ``a0`` / ``waist`` / ``duration`` override the spec's values and may be
    0-d tensors that require grad: the gradient subsystem (`grad.params`)
    differentiates the pulse through them. With no override the result is
    the spec's pulse as before."""
    nx, ny, nz = grid.shape
    dev, dtype = fields.ex.device, fields.ex.dtype

    def scalar(value):
        if isinstance(value, torch.Tensor):
            return value.to(dtype=dtype, device=dev)
        return torch.tensor(value, dtype=dtype, device=dev)

    x = torch.arange(nx, dtype=dtype, device=dev)[:, None, None] + 0.5  # Ex is x-staggered
    y = torch.arange(ny, dtype=dtype, device=dev)[None, :, None]
    z = torch.arange(nz, dtype=dtype, device=dev)[None, None, :]
    a0 = scalar(spec.a0 if a0 is None else a0)
    waist = scalar(spec.waist if waist is None else waist)
    duration = scalar(spec.duration if duration is None else duration)

    xr, yr = x - nx / 2, y - ny / 2
    r2 = xr * xr + yr * yr
    k0 = 2.0 * math.pi / spec.wavelength

    def pulse(zz):
        zr = (zz - spec.z_center) / duration
        envelope = torch.exp(-r2 / (waist * waist) - zr * zr)
        return a0 * k0 * envelope * torch.cos(k0 * (zz - spec.z_center))

    ex = pulse(z)
    by = pulse(z + 0.5)  # By staggered at (i+1/2, j, k+1/2): same expression at z+1/2
    return dataclasses.replace(fields, ex=fields.ex + ex, by=fields.by + by)

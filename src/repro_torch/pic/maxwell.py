"""FDTD Maxwell solver on the periodic Yee grid with optional CKC
(Cole-Karkkainen-Cowan) smoothing. Counterpart of the periodic part of
`repro.pic.maxwell`, and of its guard-padded curls (`curl_b_padded`,
`curl_e_padded`), which the distributed driver's shards run on 1-cell
halos.

Normalized units: dE/dt = curl B - J ; dB/dt = -curl E. Differences are
`torch.roll`-based (periodic). The spatial axes are a field's last three,
so an ensemble bucket's fields (B, nx, ny, nz) step every member at once.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.pic.grid import FieldState


def _d_down(f, axis, d):
    """Backward difference (f[i] - f[i-1])/d along spatial ``axis`` — for
    curls landing on E."""
    return (f - torch.roll(f, 1, dims=axis - 3)) / d


def _d_up(f, axis, d):
    """Forward difference (f[i+1] - f[i])/d along spatial ``axis`` — for
    curls landing on B."""
    return (torch.roll(f, -1, dims=axis - 3) - f) / d


def curl_b(fields: FieldState, dx):
    """curl B evaluated at E locations."""
    bx, by, bz = fields.b()
    cx = _d_down(bz, 1, dx[1]) - _d_down(by, 2, dx[2])
    cy = _d_down(bx, 2, dx[2]) - _d_down(bz, 0, dx[0])
    cz = _d_down(by, 0, dx[0]) - _d_down(bx, 1, dx[1])
    return cx, cy, cz


def curl_e(fields: FieldState, dx):
    """curl E evaluated at B locations."""
    ex, ey, ez = fields.e()
    cx = _d_up(ez, 1, dx[1]) - _d_up(ey, 2, dx[2])
    cy = _d_up(ex, 2, dx[2]) - _d_up(ez, 0, dx[0])
    cz = _d_up(ey, 0, dx[0]) - _d_up(ex, 1, dx[1])
    return cx, cy, cz


def _ckc_smooth(f, axes, beta):
    """CKC transverse smoothing of a difference field: (1-2b) f + b (f+ + f-)
    along each transverse axis. beta=0 reduces to plain Yee."""
    for ax in axes:
        f = (1 - 2 * beta) * f + beta * (torch.roll(f, 1, dims=ax - 3) + torch.roll(f, -1, dims=ax - 3))
    return f


def push_b(fields: FieldState, *, dx, dt: float, ckc_beta: float = 0.0) -> FieldState:
    """B -= dt * curl E (CKC smooths the curl)."""
    cx, cy, cz = curl_e(fields, dx)
    if ckc_beta:
        cx = _ckc_smooth(cx, (1, 2), ckc_beta)
        cy = _ckc_smooth(cy, (0, 2), ckc_beta)
        cz = _ckc_smooth(cz, (0, 1), ckc_beta)
    return dataclasses.replace(fields, bx=fields.bx - dt * cx, by=fields.by - dt * cy, bz=fields.bz - dt * cz)


def push_e(fields: FieldState, j, *, dx, dt: float) -> FieldState:
    """E += dt * (curl B - J)."""
    cx, cy, cz = curl_b(fields, dx)
    jx, jy, jz = j
    return dataclasses.replace(
        fields, ex=fields.ex + dt * (cx - jx), ey=fields.ey + dt * (cy - jy), ez=fields.ez + dt * (cz - jz)
    )


def maxwell_step(fields: FieldState, j, *, dx, dt: float, ckc_beta: float = 0.0) -> FieldState:
    """Leapfrog step: half-B, full-E, half-B (fields end co-timed)."""
    fields = push_b(fields, dx=dx, dt=0.5 * dt, ckc_beta=ckc_beta)
    fields = push_e(fields, j, dx=dx, dt=dt)
    return push_b(fields, dx=dx, dt=0.5 * dt, ckc_beta=ckc_beta)


# -- guard-padded curls (the distributed driver's Maxwell update) ------------
#
# The same differences, with the neighbours' values read from exchanged
# halos instead of `torch.roll`. Arrays carry g >= 1 guard cells on each
# side of their last three axes; leading axes (a stack of shards) ride
# along.


def _core(f, g, shape):
    nx, ny, nz = shape
    return f[..., g : g + nx, g : g + ny, g : g + nz]


def _shift(f, g, shape, axis, delta):
    nx, ny, nz = shape
    sl = [slice(g, g + nx), slice(g, g + ny), slice(g, g + nz)]
    sl[axis] = slice(g + delta, g + delta + shape[axis])
    return f[(Ellipsis, *sl)]


def curl_b_padded(bx, by, bz, g: int, shape, dx):
    """curl B at the E locations from guard-padded B (backward differences)."""
    d = lambda f, ax: (_core(f, g, shape) - _shift(f, g, shape, ax, -1)) / dx[ax]
    cx = d(bz, 1) - d(by, 2)
    cy = d(bx, 2) - d(bz, 0)
    cz = d(by, 0) - d(bx, 1)
    return cx, cy, cz


def curl_e_padded(ex, ey, ez, g: int, shape, dx):
    """curl E at the B locations from guard-padded E (forward differences)."""
    d = lambda f, ax: (_shift(f, g, shape, ax, 1) - _core(f, g, shape)) / dx[ax]
    cx = d(ez, 1) - d(ey, 2)
    cy = d(ex, 2) - d(ez, 0)
    cz = d(ey, 0) - d(ex, 1)
    return cx, cy, cz

"""FDTD Maxwell solver on the periodic Yee grid with optional CKC
(Cole-Karkkainen-Cowan) smoothing. Counterpart of the periodic part of
`repro.pic.maxwell`.

Normalized units: dE/dt = curl B - J ; dB/dt = -curl E. Differences are
`torch.roll`-based (periodic).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.pic.grid import FieldState


def _d_down(f, axis, d):
    """Backward difference (f[i] - f[i-1])/d — for curls landing on E."""
    return (f - torch.roll(f, 1, dims=axis)) / d


def _d_up(f, axis, d):
    """Forward difference (f[i+1] - f[i])/d — for curls landing on B."""
    return (torch.roll(f, -1, dims=axis) - f) / d


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
        f = (1 - 2 * beta) * f + beta * (torch.roll(f, 1, dims=ax) + torch.roll(f, -1, dims=ax))
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

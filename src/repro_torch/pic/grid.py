"""Yee grid specification (normalized units: c = eps0 = mu0 = 1).

Counterpart of `repro.pic.grid`. Field staggering (standard Yee):
  Ex (i+1/2, j,     k    )   Bx (i,     j+1/2, k+1/2)
  Ey (i,     j+1/2, k    )   By (i+1/2, j,     k+1/2)
  Ez (i,     j,     k+1/2)   Bz (i+1/2, j+1/2, k    )
J is co-located with E. Particle positions are in grid units.
"""

from __future__ import annotations

import dataclasses
import math

import torch

Stagger = tuple[bool, bool, bool]

E_STAGGER: tuple[Stagger, Stagger, Stagger] = (
    (True, False, False),
    (False, True, False),
    (False, False, True),
)
B_STAGGER: tuple[Stagger, Stagger, Stagger] = (
    (False, True, True),
    (True, False, True),
    (True, True, False),
)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    shape: tuple[int, int, int]
    dx: tuple[float, float, float] = (1.0, 1.0, 1.0)

    @property
    def n_cells(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]

    @property
    def cell_volume(self) -> float:
        return self.dx[0] * self.dx[1] * self.dx[2]

    def cfl_dt(self, safety: float = 0.99) -> float:
        """Courant limit for the Yee solver (c = 1)."""
        inv2 = sum(1.0 / d**2 for d in self.dx)
        return safety / math.sqrt(inv2)


@dataclasses.dataclass(frozen=True)
class FieldState:
    """Periodic-core field arrays, each (nx, ny, nz)."""

    ex: torch.Tensor
    ey: torch.Tensor
    ez: torch.Tensor
    bx: torch.Tensor
    by: torch.Tensor
    bz: torch.Tensor

    @staticmethod
    def zeros(shape, dtype=torch.float32, device=None) -> "FieldState":
        z = lambda: torch.zeros(tuple(shape), dtype=dtype, device=device)
        return FieldState(z(), z(), z(), z(), z(), z())

    def e(self):
        return (self.ex, self.ey, self.ez)

    def b(self):
        return (self.bx, self.by, self.bz)

    def all(self):
        """The six components in EB_STAGGERS order (Ex, Ey, Ez, Bx, By, Bz)."""
        return (self.ex, self.ey, self.ez, self.bx, self.by, self.bz)

    def energy(self, cell_volume: float) -> torch.Tensor:
        em = sum(0.5 * torch.sum(f.to(torch.float32) * f.to(torch.float32)) for f in self.all())
        return em * cell_volume

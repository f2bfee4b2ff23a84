"""rhocell layout and its dense grid reduction (paper §3.4 / Eq. 5).

Counterpart of `repro.core.rhocell`: a rhocell holds, for every cell, its
particles' contributions to the fixed tap window around it,
``(n_cells, Tx, Ty, Tz)``; the reduction to the grid is a set of
statically-shifted dense adds. Grids come back padded with `guard` cells on
every side; periodic runs fold the guards back with `fold_guards`.

The adds run in the reference's order, slice by slice. Every function
here also takes a leading member axis (an ensemble bucket's): the spatial
axes are indexed from the end, and each member's grid gets the adds its
solo grid gets.
"""

from __future__ import annotations

import torch


def reduce_rhocell(rho_cells: torch.Tensor, grid_shape, bases, guard: int) -> torch.Tensor:
    """Direct reduction: Tx*Ty*Tz shifted adds. rho_cells: ([B,] n_cells,
    Tx, Ty, Tz)."""
    nx, ny, nz = grid_shape
    g = guard
    *lead, _, tx, ty, tz = rho_cells.shape
    bx, by, bz = bases
    rho = rho_cells.reshape(*lead, nx, ny, nz, tx, ty, tz)
    out = rho_cells.new_zeros((*lead, nx + 2 * g, ny + 2 * g, nz + 2 * g))
    for a in range(tx):
        for b in range(ty):
            for c in range(tz):
                out[
                    ...,
                    g + bx + a : g + bx + a + nx,
                    g + by + b : g + by + b + ny,
                    g + bz + c : g + bz + c + nz,
                ] += rho[..., a, b, c]
    return out


def reduce_rhocell_separable(rho_cells: torch.Tensor, grid_shape, bases, guard: int) -> torch.Tensor:
    """Axis-separable reduction (same result, Tx+Ty+Tz passes)."""
    nx, ny, nz = grid_shape
    g = guard
    *lead, _, tx, ty, tz = rho_cells.shape
    bz = bases[2]
    rho = rho_cells.reshape(*lead, nx, ny, nz, tx, ty, tz)
    acc_z = rho_cells.new_zeros((*lead, nx, ny, nz + 2 * g, tx, ty))
    for c in range(tz):
        acc_z[..., g + bz + c : g + bz + c + nz, :, :] += rho[..., c]
    return reduce_rhocell_tail(acc_z, grid_shape, bases[:2], g)


def reduce_rhocell_tail(acc_z: torch.Tensor, grid_shape, bases_xy, guard: int) -> torch.Tensor:
    """The y/x passes of the separable reduction:
    ``acc_z ([B,] nx, ny, nz+2g, Tx, Ty) -> padded grid``. Shared with the
    epilogue-fused deposition, whose kernel does the z pass itself."""
    nx, ny, nz = grid_shape
    g = guard
    *lead, _, _, _, tx, ty = acc_z.shape
    bx, by = bases_xy
    acc_y = acc_z.new_zeros((*lead, nx, ny + 2 * g, nz + 2 * g, tx))
    for b in range(ty):
        acc_y[..., g + by + b : g + by + b + ny, :, :] += acc_z[..., b]
    out = acc_z.new_zeros((*lead, nx + 2 * g, ny + 2 * g, nz + 2 * g))
    for a in range(tx):
        out[..., g + bx + a : g + bx + a + nx, :, :] += acc_y[..., a]
    return out


def _fold_axis(x: torch.Tensor, guard: int, axis: int) -> torch.Tensor:
    g = guard
    n = x.shape[axis] - 2 * g
    assert n >= g, f"grid dim {n} smaller than guard {g}"
    x = torch.movedim(x, axis, 0)
    lo, core, hi = x[:g], x[g : g + n].clone(), x[g + n :]
    core[:g] += hi       # beyond-right wraps to start
    core[n - g :] += lo  # beyond-left wraps to end
    return torch.movedim(core, 0, axis)


def fold_guards(padded: torch.Tensor, guard: int) -> torch.Tensor:
    """Fold guard cells periodically: ([B,] (n+2g)^3) -> ([B,] n^3)."""
    out = padded
    for axis in (-3, -2, -1):
        out = _fold_axis(out, guard, axis)
    return out.contiguous()


def unfold_guards(grid: torch.Tensor, guard: int, *, dims=(0, 1, 2)) -> torch.Tensor:
    """Periodic-pad a core grid with guard cells on each of ``dims`` (the
    inverse view of fold). ``dims`` lets a stack of grids ``(k, nx, ny, nz)``
    pad its three spatial axes in one pass."""
    out = grid
    for axis in dims:
        n = out.shape[axis]
        idx = torch.arange(-guard, n + guard, device=grid.device) % n
        out = torch.index_select(out, axis, idx)
    return out

"""Current deposition: the Matrix-PIC fused path, its comparison modes and
the scatter oracle.

Counterpart of `repro.core.deposition`:

  deposit_scatter                 — per-particle scatter-add of the
                                    (order+1)^3 nodal contributions; the
                                    ``deposition="scatter"`` baseline and
                                    the oracle the tests hold the others to.
  deposit_rhocell                 — per-particle taps scatter into per-cell
                                    rhocell rows, then one dense reduction
                                    (``deposition="rhocell"``).
  deposit_matrix                  — one current component per call: the
                                    bin operands A (C, cap, Tx) and
                                    B (C, cap, Ty*Tz) are built in device
                                    memory, then contracted per cell
                                    (``deposition="matrix_unfused"``).
  deposit_current_matrix_fused    — all three Yee-staggered current
                                    components in one fused pass over the
                                    step's bin slab (paper Alg. 2).

The post-slab contraction has three finishing routes, chosen by the kernel
dispatcher (`repro_torch.kernels.dispatch`):

  torch         `_fused_grids_torch`: plain tensor ops, each component on
                its true support (the reference's ``xla`` route);
  cuda          the fused CUDA kernel's packed (C, 3, T, T·T) tiles,
                finished by `_fused_grids_packed`;
  cuda_reduced  the epilogue-fused CUDA kernel, which does the rhocell z
                pass itself; `_fused_grids_reduced` runs the y/x tail.

All routes return guard-padded grids.

Every function here also takes an ensemble bucket's operands, with a
leading member axis on positions, values, layout and slab: each member
deposits into its own grid (B, nx+2g, ny+2g, nz+2g), as its solo run
would, and each kernel launches once for every member.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.core import shape_functions as sf
from repro_torch.core.binning import (
    BinnedLayout,
    BinSlab,
    bin_slab_values,
    build_bin_slab,
    cell_coords,
    member_offsets,
    slot_gather,
)
from repro_torch.core.rhocell import fold_guards, reduce_rhocell, reduce_rhocell_separable, reduce_rhocell_tail
from repro_torch.grad.remat import recomputed

Stagger = tuple[bool, bool, bool]

NO_STAGGER: Stagger = (False, False, False)
STAGGER_X: Stagger = (True, False, False)
STAGGER_Y: Stagger = (False, True, False)
STAGGER_Z: Stagger = (False, False, True)

CURRENT_STAGGER: tuple[Stagger, Stagger, Stagger] = (STAGGER_X, STAGGER_Y, STAGGER_Z)


def _taps_and_bases(order: int, stagger: Stagger):
    t, b = zip(*(sf.support(order, s) for s in stagger))
    return t, b


def _per_dim_weights(pos, cells, order: int, stagger: Stagger):
    """1-D shape factors per dimension. pos/cells: (..., 3)."""
    d = pos - cells.to(pos.dtype)
    return [sf.shape_weights(d[..., k], order, stagger[k]) for k in range(3)]


def _tap_products(wx, wy, wz):
    """The (..., Tx, Ty, Tz) products of per-particle 1-D weights."""
    return wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]


def deposit_scatter(pos, values, *, grid_shape, order: int, stagger: Stagger = NO_STAGGER, guard: int | None = None):
    """Scatter-add deposition. pos: ([B,] Np, 3) grid units; values: ([B,]
    Np) q*w*v. Returns the guard-padded grid ([B,] nx+2g, ny+2g, nz+2g)."""
    nx, ny, nz = grid_shape
    g = sf.max_guard(order) if guard is None else guard
    cells = torch.floor(pos).long()
    wx, wy, wz = _per_dim_weights(pos, cells, order, stagger)
    (tx, ty, tz), (bx, by, bz) = _taps_and_bases(order, stagger)

    contrib = values[..., None, None, None] * _tap_products(wx, wy, wz)

    nxp, nyp, nzp = nx + 2 * g, ny + 2 * g, nz + 2 * g
    dev = pos.device
    ix = cells[..., 0, None] + (bx + g) + torch.arange(tx, device=dev)
    iy = cells[..., 1, None] + (by + g) + torch.arange(ty, device=dev)
    iz = cells[..., 2, None] + (bz + g) + torch.arange(tz, device=dev)
    flat = (ix[..., :, None, None] * nyp + iy[..., None, :, None]) * nzp + iz[..., None, None, :]
    lead = values.shape[:-1]
    if lead:  # each member into its own grid, in one add
        flat = flat + member_offsets(flat, nxp * nyp * nzp)
    grid = torch.zeros(math.prod(lead) * nxp * nyp * nzp, dtype=values.dtype, device=dev)
    grid.index_add_(0, flat.reshape(-1), contrib.reshape(-1))
    return grid.reshape(*lead, nxp, nyp, nzp)


def deposit_rhocell(pos, values, cell_ids, *, grid_shape, order: int, stagger: Stagger = NO_STAGGER,
                    guard: int | None = None):
    """Per-particle taps scatter into the per-cell rhocell row, then one
    dense reduction (Eq. 5). Conflicts are confined to a cell's row.
    ``cell_ids``: ([B,] Np) flattened cell of each particle."""
    nx, ny, nz = grid_shape
    g = sf.max_guard(order) if guard is None else guard
    n_cells = nx * ny * nz
    cells = torch.floor(pos).long()
    wx, wy, wz = _per_dim_weights(pos, cells, order, stagger)
    (tx, ty, tz), bases = _taps_and_bases(order, stagger)
    contrib = (values[..., None, None, None] * _tap_products(wx, wy, wz)).reshape(-1, tx * ty * tz)
    lead = values.shape[:-1]
    cell_ids = cell_ids.long()
    if lead:  # each member's cells after the one before's
        cell_ids = cell_ids + member_offsets(cell_ids, n_cells)
    rho = torch.zeros((math.prod(lead) * n_cells, tx * ty * tz), dtype=values.dtype, device=values.device)
    rho.index_add_(0, cell_ids.reshape(-1), contrib)
    return reduce_rhocell(rho.reshape(*lead, n_cells, tx, ty, tz), grid_shape, bases, g)


def binned_shape_factors(pos, values, layout: BinnedLayout, *, grid_shape, order: int, stagger: Stagger):
    """Stage 1 of the unfused deposition (Alg. 2, "VPU preprocessing"):
    gather the bins' particle data and build the contraction operands on the
    component's true support.

    Returns ``A`` ([B,] C, cap, Tx) = w * s_x (exactly 0 on gap slots) and
    ``B`` ([B,] C, cap, Ty*Tz) = s_y (x) s_z."""
    slots = layout.slots
    n_cells = slots.shape[-2]
    valid = slots >= 0
    pos_b = slot_gather(pos, slots)
    val_b = torch.where(valid, slot_gather(values, slots), torch.zeros((), dtype=values.dtype, device=values.device))
    cells = cell_coords(n_cells, grid_shape, device=pos.device)
    d = pos_b - cells[:, None, :].to(pos.dtype)
    wx = sf.shape_weights(d[..., 0], order, stagger[0])
    wy = sf.shape_weights(d[..., 1], order, stagger[1])
    wz = sf.shape_weights(d[..., 2], order, stagger[2])
    a = wx * val_b[..., None]
    b = (wy[..., :, None] * wz[..., None, :]).reshape(*slots.shape, -1)
    return a, b


def _bin_matmul(a, b):
    """rhocell[c] = A_c^T B_c — the sum of outer products, added slot by slot
    in slot order. Not a batched matmul: its kernel, and so its summation
    order, can change with the slot count, and an ensemble's re-binned
    member (the same occupied slots, more zero-padded ones) must deposit
    the same bits at any capacity."""
    out = a[..., 0, :, None] * b[..., 0, None, :]
    for p in range(1, a.shape[-2]):
        out.addcmul_(a[..., p, :, None], b[..., p, None, :])
    return out


def deposit_matrix(pos, values, layout: BinnedLayout, *, grid_shape, order: int, stagger: Stagger = NO_STAGGER,
                   guard: int | None = None, separable_reduce: bool = True, backend: str = "auto"):
    """Matrix-PIC deposition of one current component (the
    ``deposition="matrix_unfused"`` mode): build A and B
    (`binned_shape_factors`), contract them per cell through the dispatcher
    op ``deposit_unfused`` (``cuda``: the `bin_outer_product` kernel;
    ``torch``: `_bin_matmul`, slot by slot), reduce the rhocell tiles. Returns the
    guard-padded grid."""
    from repro_torch.kernels import dispatch

    grid_shape = tuple(grid_shape)
    g = sf.max_guard(order) if guard is None else guard
    (tx, ty, tz), bases = _taps_and_bases(order, stagger)
    a, b = binned_shape_factors(pos, values, layout, grid_shape=grid_shape, order=order, stagger=stagger)
    lead = layout.slots.shape[:-2]
    if dispatch.resolve("deposit_unfused", backend, device=pos.device, order=order, grid_shape=grid_shape,
                        capacity=layout.capacity, dtype=values.dtype, batch=math.prod(lead)) == "cuda":
        from repro_torch.kernels.deposition.ops import bin_outer_product

        rho = bin_outer_product(a.contiguous(), b.contiguous())
    else:
        rho = _bin_matmul(a, b)
    reduce = reduce_rhocell_separable if separable_reduce else reduce_rhocell
    return reduce(rho.reshape(*lead, -1, tx, ty, tz), grid_shape, bases, g)


def fused_bin_slab(pos, vel, qw, layout: BinnedLayout, *, grid_shape):
    """The two (n_cells, cap, 3) slabs the fused kernels stream: offsets
    ``d`` and values ``val`` (q·w·v, exactly 0 on gap slots)."""
    slab = build_bin_slab(pos, layout, grid_shape=grid_shape)
    return slab.d, bin_slab_values(vel, qw, layout, slab)


def _fused_grids_torch(d, val, *, grid_shape, order, guard):
    """The plain fused route (the reference's ``_fused_grids_xla``): six
    shared weight sets, each component contracted on its true support."""
    lead = d.shape[:-3]
    w_u = [sf.shape_weights(d[..., k], order, False) for k in range(3)]
    w_s = [sf.shape_weights(d[..., k], order, True) for k in range(3)]
    out = []
    for comp in range(3):
        stagger = CURRENT_STAGGER[comp]
        (tx, ty, tz), bases = _taps_and_bases(order, stagger)
        wx = w_s[0] if stagger[0] else w_u[0]
        wy = w_s[1] if stagger[1] else w_u[1]
        wz = w_s[2] if stagger[2] else w_u[2]
        a = wx * val[..., comp][..., None]
        byz = (wy[..., :, None] * wz[..., None, :]).reshape(*d.shape[:-1], -1)
        rho = _bin_matmul(a, byz).reshape(*lead, -1, tx, ty, tz)
        out.append(reduce_rhocell_separable(rho, grid_shape, bases, guard))
    return out


def _fused_grids_packed(packed, *, grid_shape, order, guard):
    """Finish the packed ([B,] C, 3, T, T*T) tiles: one rhocell reduction per
    component on the unified window."""
    t, base = sf.unified_support(order)
    bases = (base, base, base)
    lead = packed.shape[:-4]
    return [
        reduce_rhocell_separable(packed[..., comp, :, :].reshape(*lead, -1, t, t, t), grid_shape, bases, guard)
        for comp in range(3)
    ]


def _fused_grids_reduced(acc, *, grid_shape, order, guard):
    """Finish the epilogue-fused ([B,] C_xy, 3, nz+2g, T, T) accumulators:
    the z pass already happened in the kernel, the y/x tail remains."""
    nx, ny, nz = grid_shape
    g = guard
    t, base = sf.unified_support(order)
    lead = acc.shape[:-5]
    return [
        reduce_rhocell_tail(acc[..., comp, :, :, :].reshape(*lead, nx, ny, nz + 2 * g, t, t), grid_shape,
                            (base, base), g)
        for comp in range(3)
    ]


def fused_deposit_grids(d, val, *, grid_shape, order: int, guard: int | None = None, backend: str = "torch"):
    """Post-slab fused deposition: ([B,] C, cap, 3) offsets and values ->
    [Jx, Jy, Jz] guard-padded, through the named dispatcher backend. Every
    route reduces the rhocell tiles axis by axis (the reference's default
    ``separable_reduce=True``)."""
    from repro_torch.kernels import dispatch

    grid_shape = tuple(grid_shape)
    g = sf.max_guard(order) if guard is None else guard
    name = dispatch.resolve("deposit_fused", backend, device=d.device, order=order, grid_shape=grid_shape,
                            capacity=d.shape[-2], dtype=val.dtype, batch=math.prod(d.shape[:-3]))
    if name == "cuda_reduced":
        from repro_torch.kernels.deposition.ops import fused_bin_deposit_reduced

        acc = fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid_shape, guard=g)
        return _fused_grids_reduced(acc, grid_shape=grid_shape, order=order, guard=g)
    if name == "cuda":
        from repro_torch.kernels.deposition.ops import fused_bin_deposit

        packed = fused_bin_deposit(d, val, order=order)
        return _fused_grids_packed(packed, grid_shape=grid_shape, order=order, guard=g)
    # under autograd, the backward keeps d and val and recomputes the
    # per-tap weights and operands (`grad.remat.recomputed`)
    return recomputed(functools.partial(_fused_grids_torch, grid_shape=grid_shape, order=order, guard=g), d, val)


def deposit_current_matrix_fused(pos, vel, qw, layout: BinnedLayout, *, grid_shape, order: int,
                                 guard: int | None = None, slab: BinSlab | None = None,
                                 backend: str = "auto", values=None):
    """All three Yee-staggered current components in one fused pass — the
    `Simulation` deposition hot path. Returns [Jx, Jy, Jz] guard-padded.

    ``slab`` is the step's prebuilt `BinSlab` (consistent with ``pos`` and
    ``layout``); ``values`` the q·w·v slab staged with it
    (`binning.bin_slab_staging`), in which case no slot-table gather runs
    here at all."""
    if slab is None:
        slab = build_bin_slab(pos, layout, grid_shape=grid_shape)
    val = values if values is not None else bin_slab_values(vel, qw, layout, slab)
    return fused_deposit_grids(slab.d, val, grid_shape=grid_shape, order=order, guard=guard, backend=backend)


def deposit_current(pos, vel, qw, *, grid_shape, order: int, method: str = "matrix", layout: BinnedLayout | None = None,
                    cell_ids=None, fold: bool = True, **kw):
    """All three Yee-staggered current components by one method: ``matrix``
    (the fused path), ``matrix_unfused``, ``scatter`` or ``rhocell``.
    Counterpart of `repro.core.deposition.deposit_current`.

    vel: (Np, 3); qw: (Np,) charge*weight; ``layout`` for the matrix
    methods, ``cell_ids`` for rhocell; ``kw`` goes to the method's function
    (``guard``, ``backend``, ...). Returns [Jx, Jy, Jz], folded periodic
    grids if ``fold``, else guard-padded."""
    # fold with the guard the deposit used
    g = kw.get("guard")
    g = sf.max_guard(order) if g is None else g
    if method == "matrix":
        if layout is None:
            raise ValueError("method 'matrix' needs a layout")
        out = deposit_current_matrix_fused(pos, vel, qw, layout, grid_shape=grid_shape, order=order, **kw)
        return [fold_guards(j, g) if fold else j for j in out]
    out = []
    for comp in range(3):
        values = qw * vel[..., comp]
        stagger = CURRENT_STAGGER[comp]
        if method == "scatter":
            j = deposit_scatter(pos, values, grid_shape=grid_shape, order=order, stagger=stagger, **kw)
        elif method == "rhocell":
            if cell_ids is None:
                raise ValueError("method 'rhocell' needs cell_ids")
            j = deposit_rhocell(pos, values, cell_ids, grid_shape=grid_shape, order=order, stagger=stagger, **kw)
        elif method == "matrix_unfused":
            if layout is None:
                raise ValueError("method 'matrix_unfused' needs a layout")
            j = deposit_matrix(pos, values, layout, grid_shape=grid_shape, order=order, stagger=stagger, **kw)
        else:
            raise ValueError(f"unknown method {method!r}")
        out.append(fold_guards(j, g) if fold else j)
    return out

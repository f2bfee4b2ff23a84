"""Field gather (grid -> particles), the inverse of deposition.

Counterpart of `repro.core.gather`. Per cell, the node
neighbourhood is shared by every particle in the bin; each particle's value
is a small contraction against its tap weights,

    E_p = sum_{m,n} wx_p[m] * (B_p[n] * G_c[m, n])     (B = wy (x) wz).

`gather_fields_fused` gathers all six components in one pass over the
step's `BinSlab` and scatters them back to particle order through one
slot-map gather (``gather="matrix"``). Its contraction has two routes,
chosen by the kernel dispatcher: ``torch`` (`_fused_gather_torch_bins`, each
component on its true support) and ``cuda`` (the fused CUDA kernel, which
reads the six guard-padded grids directly). `gather_matrix` gathers one
component per call, re-staging the slab and its weights each time
(``gather="matrix_unfused"``, the six-call ablation; dispatcher op
``bin_gather``). `gather_scatter` is the per-particle baseline
(``gather="scatter"``) and the oracle.

Field grids travel as one stacked ``(6, nx+2g, ny+2g, nz+2g)`` tensor in
`EB_STAGGERS` order (Ex, Ey, Ez, Bx, By, Bz).
"""

from __future__ import annotations

import torch

from repro_torch.core import shape_functions as sf
from repro_torch.core.binning import BinnedLayout, BinSlab, cell_coords, slot_gather
from repro_torch.core.deposition import NO_STAGGER, Stagger, _per_dim_weights, _taps_and_bases

EB_STAGGERS: tuple[Stagger, ...] = (
    (True, False, False), (False, True, False), (False, False, True),
    (False, True, True), (True, False, True), (True, True, False),
)


def gather_scatter(pos, grid_padded, *, order: int, stagger: Stagger = NO_STAGGER, guard: int | None = None):
    """Baseline per-particle gather from a guard-padded grid: (Np,) values."""
    g = sf.max_guard(order) if guard is None else guard
    cells = torch.floor(pos).long()
    wx, wy, wz = _per_dim_weights(pos, cells, order, stagger)
    (tx, ty, tz), (bx, by, bz) = _taps_and_bases(order, stagger)
    nxp, nyp, nzp = grid_padded.shape
    dev = pos.device
    ix = cells[:, 0, None] + (bx + g) + torch.arange(tx, device=dev)
    iy = cells[:, 1, None] + (by + g) + torch.arange(ty, device=dev)
    iz = cells[:, 2, None] + (bz + g) + torch.arange(tz, device=dev)
    flat = (ix[:, :, None, None] * nyp + iy[:, None, :, None]) * nzp + iz[:, None, None, :]
    vals = grid_padded.reshape(-1)[flat]
    w3 = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    return torch.sum(vals * w3, dim=(1, 2, 3))


def extract_neighborhoods(grid_padded, grid_shape, *, taps, bases, guard: int):
    """Dense per-cell tap neighbourhoods (n_cells, Tx, Ty, Tz): pure shifted
    slicing, the dual of reduce_rhocell."""
    nx, ny, nz = grid_shape
    g = guard
    tx, ty, tz = taps
    bx, by, bz = bases
    blocks = [
        grid_padded[g + bx + a : g + bx + a + nx, g + by + b : g + by + b + ny, g + bz + c : g + bz + c + nz]
        for a in range(tx) for b in range(ty) for c in range(tz)
    ]
    return torch.stack(blocks, dim=-1).reshape(nx * ny * nz, tx, ty, tz)


def gather_matrix(pos, grid_padded, layout: BinnedLayout, *, grid_shape, order: int, stagger: Stagger = NO_STAGGER,
                  guard: int | None = None, backend: str = "auto"):
    """Binned matrix gather of one component: stage the particles into bin
    order, build their weights on the component's true support, contract
    against each cell's neighbourhood through the dispatcher op
    ``bin_gather`` (``cuda``: the `bin_gather` kernel; ``torch``: an einsum
    and a tap sum), scatter back through the slot map. Returns (Np,) values,
    0 for unslotted particles."""
    from repro_torch.kernels import dispatch

    grid_shape = tuple(grid_shape)
    g = sf.max_guard(order) if guard is None else guard
    taps, bases = _taps_and_bases(order, stagger)
    tx, ty, tz = taps
    slots = layout.slots
    n_cells, cap = slots.shape
    neigh = extract_neighborhoods(grid_padded, grid_shape, taps=taps, bases=bases, guard=g).reshape(n_cells, tx, ty * tz)
    valid = slots >= 0
    pos_b = slot_gather(pos, slots)
    cells = cell_coords(n_cells, grid_shape, device=pos.device)
    d = pos_b - cells[:, None, :].to(pos.dtype)
    wx = sf.shape_weights(d[..., 0], order, stagger[0])
    wy = sf.shape_weights(d[..., 1], order, stagger[1])
    wz = sf.shape_weights(d[..., 2], order, stagger[2])
    byz = (wy[..., :, None] * wz[..., None, :]).reshape(n_cells, cap, ty * tz)
    if dispatch.resolve("bin_gather", backend, device=pos.device, order=order, grid_shape=grid_shape, capacity=cap,
                        dtype=pos.dtype) == "cuda":
        from repro_torch.kernels.gather.ops import bin_gather

        e_bins = bin_gather(wx.contiguous(), byz.contiguous(), neigh.contiguous()) * valid
    else:
        # H[c,p,m] = sum_n B[c,p,n] G[c,m,n]; E[c,p] = sum_m wx[c,p,m] H[c,p,m]
        h = torch.einsum("cpn,cmn->cpm", byz, neigh)
        e_bins = torch.sum(wx * h, dim=-1) * valid
    e_flat = e_bins.reshape(-1)
    pslot = layout.particle_slot
    return torch.where(pslot >= 0, e_flat[torch.clamp_min(pslot, 0).long()],
                       torch.zeros((), dtype=e_flat.dtype, device=e_flat.device))


def pack_neighborhoods(padded, *, grid_shape, order: int, guard: int):
    """The six neighbourhoods on the unified window, packed as
    (C, 6, T, T*T) — the operand the reference's Pallas gather kernel reads
    (`repro/core/gather.py`, `_fused_gather_pallas_bins`)."""
    nx, ny, nz = grid_shape
    t, base = sf.unified_support(order)
    return torch.stack(
        [
            extract_neighborhoods(f, grid_shape, taps=(t, t, t), bases=(base, base, base), guard=guard)
            .reshape(nx * ny * nz, t, t * t)
            for f in padded
        ],
        dim=1,
    )


def _fused_gather_torch_bins(d, padded, *, grid_shape, order, guard):
    """Plain six-component gather: shared weights, per-component true-support
    neighbourhoods, (C, cap, 6) per-bin values."""
    n_cells, cap, _ = d.shape
    w_u = [sf.shape_weights(d[..., k], order, False) for k in range(3)]
    w_s = [sf.shape_weights(d[..., k], order, True) for k in range(3)]
    byz = {}  # four distinct wy (x) wz products over the six components
    comps = []
    for comp, stagger in enumerate(EB_STAGGERS):
        taps, bases = _taps_and_bases(order, stagger)
        tx, ty, tz = taps
        neigh = extract_neighborhoods(padded[comp], grid_shape, taps=taps, bases=bases, guard=guard)
        neigh = neigh.reshape(n_cells, tx, ty * tz)
        key = (stagger[1], stagger[2])
        if key not in byz:
            wy = w_s[1] if stagger[1] else w_u[1]
            wz = w_s[2] if stagger[2] else w_u[2]
            byz[key] = (wy[..., :, None] * wz[..., None, :]).reshape(n_cells, cap, ty * tz)
        wx = w_s[0] if stagger[0] else w_u[0]
        h = torch.einsum("cpn,cmn->cpm", byz[key], neigh)
        comps.append(torch.sum(wx * h, dim=-1))
    return torch.stack(comps, dim=-1)


def fused_gather_bins(d, padded, *, grid_shape, order: int, guard: int | None = None, backend: str = "torch"):
    """Post-slab fused gather: (C, cap, 3) offsets and the stacked padded
    grids (6, nx+2g, ny+2g, nz+2g) -> (C, cap, 6) per-bin values, through
    the named dispatcher backend."""
    from repro_torch.kernels import dispatch

    grid_shape = tuple(grid_shape)
    g = sf.max_guard(order) if guard is None else guard
    name = dispatch.resolve("gather_fused", backend, device=d.device, order=order, grid_shape=grid_shape,
                            capacity=d.shape[1], dtype=d.dtype)
    if name == "cuda":
        from repro_torch.kernels.gather.ops import fused_bin_gather

        return fused_bin_gather(d, padded, grid_shape=grid_shape, order=order, guard=g)
    return _fused_gather_torch_bins(d, padded, grid_shape=grid_shape, order=order, guard=g)


def gather_fields_fused(slab: BinSlab, padded, layout: BinnedLayout, *, grid_shape, order: int,
                        guard: int | None = None, backend: str = "auto"):
    """All six Yee-staggered field components in one fused pass — the
    ``gather="matrix"`` hot path.

    ``slab`` is the step's `BinSlab`; ``padded`` the stacked guard-padded
    grids in `EB_STAGGERS` order. Returns ``(e_p, b_p)``, (Np, 3) each, 0 for
    unslotted particles."""
    n_cells, cap = slab.valid.shape
    e_bins = fused_gather_bins(slab.d, padded, grid_shape=grid_shape, order=order, guard=guard, backend=backend)
    # ONE scatter back to particle order for all six components
    flat = e_bins.reshape(n_cells * cap, 6)
    pslot = layout.particle_slot
    vals = torch.where(
        pslot[:, None] >= 0, flat[torch.clamp_min(pslot, 0).long()], torch.zeros((), dtype=flat.dtype, device=flat.device)
    )
    return vals[:, :3], vals[:, 3:]

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
`EB_STAGGERS` order (Ex, Ey, Ez, Bx, By, Bz). Every function here also
takes an ensemble bucket's operands, with a leading member axis on
positions, grids, layout and slab (the stacked grids (B, 6, ...)): each
member gathers from its own grids, and each kernel launches once for
every member.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.core import shape_functions as sf
from repro_torch.core.binning import BinnedLayout, BinSlab, cell_coords, member_offsets, slot_gather
from repro_torch.core.deposition import NO_STAGGER, Stagger, _per_dim_weights, _taps_and_bases
from repro_torch.grad.remat import recomputed

EB_STAGGERS: tuple[Stagger, ...] = (
    (True, False, False), (False, True, False), (False, False, True),
    (False, True, True), (True, False, True), (True, True, False),
)


def gather_scatter(pos, grid_padded, *, order: int, stagger: Stagger = NO_STAGGER, guard: int | None = None):
    """Baseline per-particle gather from a guard-padded grid: ([B,] Np)
    values."""
    g = sf.max_guard(order) if guard is None else guard
    cells = torch.floor(pos).long()
    wx, wy, wz = _per_dim_weights(pos, cells, order, stagger)
    (tx, ty, tz), (bx, by, bz) = _taps_and_bases(order, stagger)
    nxp, nyp, nzp = grid_padded.shape[-3:]
    dev = pos.device
    ix = cells[..., 0, None] + (bx + g) + torch.arange(tx, device=dev)
    iy = cells[..., 1, None] + (by + g) + torch.arange(ty, device=dev)
    iz = cells[..., 2, None] + (bz + g) + torch.arange(tz, device=dev)
    flat = (ix[..., :, None, None] * nyp + iy[..., None, :, None]) * nzp + iz[..., None, None, :]
    if grid_padded.dim() > 3:  # each member from its own grid
        flat = flat + member_offsets(flat, nxp * nyp * nzp)
    vals = grid_padded.reshape(-1)[flat]
    w3 = wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]
    return torch.sum(vals * w3, dim=(-3, -2, -1))


def extract_neighborhoods(grid_padded, grid_shape, *, taps, bases, guard: int):
    """Dense per-cell tap neighbourhoods ([B,] n_cells, Tx, Ty, Tz): pure
    shifted slicing, the dual of reduce_rhocell."""
    nx, ny, nz = grid_shape
    g = guard
    tx, ty, tz = taps
    bx, by, bz = bases
    blocks = [
        grid_padded[..., g + bx + a : g + bx + a + nx, g + by + b : g + by + b + ny, g + bz + c : g + bz + c + nz]
        for a in range(tx) for b in range(ty) for c in range(tz)
    ]
    return torch.stack(blocks, dim=-1).reshape(*grid_padded.shape[:-3], nx * ny * nz, tx, ty, tz)


def gather_matrix(pos, grid_padded, layout: BinnedLayout, *, grid_shape, order: int, stagger: Stagger = NO_STAGGER,
                  guard: int | None = None, backend: str = "auto"):
    """Binned matrix gather of one component: stage the particles into bin
    order, build their weights on the component's true support, contract
    against each cell's neighbourhood through the dispatcher op
    ``bin_gather`` (``cuda``: the `bin_gather` kernel; ``torch``: an einsum
    and a tap sum), scatter back through the slot map. Returns ([B,] Np)
    values, 0 for unslotted particles."""
    from repro_torch.kernels import dispatch

    grid_shape = tuple(grid_shape)
    g = sf.max_guard(order) if guard is None else guard
    taps, bases = _taps_and_bases(order, stagger)
    tx, ty, tz = taps
    slots = layout.slots
    lead, (n_cells, cap) = slots.shape[:-2], slots.shape[-2:]
    neigh = extract_neighborhoods(grid_padded, grid_shape, taps=taps, bases=bases, guard=g)
    neigh = neigh.reshape(*lead, n_cells, tx, ty * tz)
    valid = slots >= 0
    pos_b = slot_gather(pos, slots)
    cells = cell_coords(n_cells, grid_shape, device=pos.device)
    d = pos_b - cells[:, None, :].to(pos.dtype)
    wx = sf.shape_weights(d[..., 0], order, stagger[0])
    wy = sf.shape_weights(d[..., 1], order, stagger[1])
    wz = sf.shape_weights(d[..., 2], order, stagger[2])
    byz = (wy[..., :, None] * wz[..., None, :]).reshape(*slots.shape, ty * tz)
    if dispatch.resolve("bin_gather", backend, device=pos.device, order=order, grid_shape=grid_shape, capacity=cap,
                        dtype=pos.dtype, batch=math.prod(lead)) == "cuda":
        from repro_torch.kernels.gather.ops import bin_gather

        e_bins = bin_gather(wx.contiguous(), byz.contiguous(), neigh.contiguous()) * valid
    else:
        # H[c,p,m] = sum_n B[c,p,n] G[c,m,n]; E[c,p] = sum_m wx[c,p,m] H[c,p,m]
        # (a bucket's members folded into the cell axis of one einsum)
        h = torch.einsum("cpn,cmn->cpm", byz.reshape(-1, cap, ty * tz), neigh.reshape(-1, tx, ty * tz))
        e_bins = torch.sum(wx * h.reshape(wx.shape), dim=-1) * valid
    return _to_particles(e_bins, layout)


def _to_particles(bins: torch.Tensor, layout: BinnedLayout) -> torch.Tensor:
    """Per-slot values ([B,] C, cap, ...) back in particle order through the
    slot map, 0 for unslotted particles: ([B,] Np, ...)."""
    lead = layout.slots.shape[:-2]
    flat = bins.reshape(-1, *bins.shape[len(lead) + 2:])
    pslot = layout.particle_slot
    idx = torch.clamp_min(pslot, 0).long()
    if lead:  # each member's slots after the one before's
        idx = idx + member_offsets(idx, layout.slots.shape[-2] * layout.slots.shape[-1])
    mask = (pslot >= 0).reshape(*pslot.shape, *([1] * (flat.dim() - 1)))
    return torch.where(mask, flat[idx], torch.zeros((), dtype=flat.dtype, device=flat.device))


def pack_neighborhoods(padded, *, grid_shape, order: int, guard: int):
    """The six neighbourhoods on the unified window, packed as
    ([B,] C, 6, T, T*T) — the operand the reference's Pallas gather kernel
    reads (`repro/core/gather.py`, `_fused_gather_pallas_bins`)."""
    nx, ny, nz = grid_shape
    t, base = sf.unified_support(order)
    return torch.stack(
        [
            extract_neighborhoods(f, grid_shape, taps=(t, t, t), bases=(base, base, base), guard=guard)
            .reshape(*f.shape[:-3], nx * ny * nz, t, t * t)
            for f in padded.unbind(-4)
        ],
        dim=-3,
    )


def _fused_gather_torch_bins(d, padded, *, grid_shape, order, guard):
    """Plain six-component gather: shared weights, per-component true-support
    neighbourhoods, (C, cap, 6) per-bin values.

    Each slot's value is its taps' products added one tap at a time in a
    fixed order, not a batched matmul: a matmul's kernel, and so its
    summation order, can change with the slot count, and an ensemble's
    re-binned member must gather the same bits at any capacity. Each
    ``addcmul_`` has a broadcast or strided operand along its inner axis, so
    it runs one code path for every slot whatever the capacity. The
    accumulator is (C, cap, tx); no (C, cap, ty*tz) product is built."""
    lead, n_cells = d.shape[:-3], d.shape[-3]
    w_u = [sf.shape_weights(d[..., k], order, False) for k in range(3)]
    w_s = [sf.shape_weights(d[..., k], order, True) for k in range(3)]
    comps = []
    for comp, stagger in enumerate(EB_STAGGERS):
        taps, bases = _taps_and_bases(order, stagger)
        tx, ty, tz = taps
        neigh = extract_neighborhoods(padded[..., comp, :, :, :], grid_shape, taps=taps, bases=bases, guard=guard)
        neigh = neigh.reshape(*lead, n_cells, tx, ty * tz)
        wx, wy, wz = (w_s[k] if stagger[k] else w_u[k] for k in range(3))
        # h[c, p, i] = sum over the (y, z) taps of wy * wz * neigh[c, i]
        h = (wy[..., 0] * wz[..., 0])[..., None] * neigh[..., None, :, 0]
        for n in range(1, ty * tz):
            h.addcmul_((wy[..., n // tz] * wz[..., n % tz])[..., None], neigh[..., None, :, n])
        e = wx[..., 0] * h[..., 0]
        for i in range(1, tx):
            e.addcmul_(wx[..., i], h[..., i])
        comps.append(e)
    return torch.stack(comps, dim=-1)


def fused_gather_bins(d, padded, *, grid_shape, order: int, guard: int | None = None, backend: str = "torch"):
    """Post-slab fused gather: ([B,] C, cap, 3) offsets and the stacked
    padded grids ([B,] 6, nx+2g, ny+2g, nz+2g) -> ([B,] C, cap, 6) per-bin
    values, through the named dispatcher backend."""
    from repro_torch.kernels import dispatch

    grid_shape = tuple(grid_shape)
    g = sf.max_guard(order) if guard is None else guard
    name = dispatch.resolve("gather_fused", backend, device=d.device, order=order, grid_shape=grid_shape,
                            capacity=d.shape[-2], dtype=d.dtype, batch=math.prod(d.shape[:-3]))
    if name == "cuda":
        from repro_torch.kernels.gather.ops import fused_bin_gather

        return fused_bin_gather(d, padded, grid_shape=grid_shape, order=order, guard=g)
    # under autograd, the backward keeps d and the grids and recomputes the
    # per-tap weights and products (`grad.remat.recomputed`)
    return recomputed(functools.partial(_fused_gather_torch_bins, grid_shape=grid_shape, order=order, guard=g),
                      d, padded)


def gather_fields_fused(slab: BinSlab, padded, layout: BinnedLayout, *, grid_shape, order: int,
                        guard: int | None = None, backend: str = "auto"):
    """All six Yee-staggered field components in one fused pass — the
    ``gather="matrix"`` hot path.

    ``slab`` is the step's `BinSlab`; ``padded`` the stacked guard-padded
    grids in `EB_STAGGERS` order. Returns ``(e_p, b_p)``, ([B,] Np, 3)
    each, 0 for unslotted particles."""
    e_bins = fused_gather_bins(slab.d, padded, grid_shape=grid_shape, order=order, guard=guard, backend=backend)
    # ONE scatter back to particle order for all six components
    vals = _to_particles(e_bins, layout)
    return vals[..., :3], vals[..., 3:]

"""Domain-decomposed PIC on one device: the shard step of the distributed
driver. Counterpart of `repro.pic.distributed`.

The reference runs one program per device under `shard_map`. Here every
shard lives on one device, stacked on two leading shard axes, as the
reference's host view stacks them:

  fields        [6, SX, SY, nx, ny, nz]   (ex, ey, ez, bx, by, bz; each
                                           shard's block of a component
                                           contiguous)
  pos, u        [SX, SY, Nloc, 3]         local-frame positions
  w, alive      [SX, SY, Nloc]
  slots         [SX, SY, C, cap]          C = nx * ny * nz local cells
  pslot         [SX, SY, Nloc]
  slab_d        [SX, SY, C, cap, 3]
  slab_valid    [SX, SY, C, cap]

and the collectives become operations on the stack:

* ``lax.ppermute(x, axis, _ring(axis, +1))`` (shard i sends to i + 1) is
  `ring_shift(x, axis, +1)`, a roll of the stacked slab along that shard
  axis: shard j receives shard j - 1's block; ``-1`` the other way;
* ``psum`` / ``pmax`` over the mesh are a sum / max over the shard axes.

Grid x is split over shard axis 0, y over shard axis 1; z stays whole
(periodic inside the shard). One step (`dist_pic_step`):

  1. field halo extension    ring shifts of the boundary slabs (x, then y,
                             then the local z wrap); or every slab sliced
                             from the raw block with the corners as two
                             hops (``comm.overlap_halo``), bit-equal
  2. gather + Boris push     per shard (the gather's kernel at the local
                             shape, one launch a shard)
  3. particle migration      bounded buffers, x then y (corners route
                             x-then-y), stable pack order, arrivals into
                             dead slots in index order
  4. GPMA update             per shard
  5. deposition              per shard (one launch a shard), then the guard
                             contributions folded onto the neighbours by
                             the reverse exchange (z, then y, then x)
  6. Maxwell                 guard-padded curls on 1-cell halos

Overflow is counted, never silent. A particle that finds no send-buffer
slot (``mig_send_overflow``) stays resident with an out-of-range local
position, is masked out of binning, gather, push and deposition
(`in_domain`) and retries the next step. A particle that finds no dead
slot at its destination (``mig_recv_dropped``) is destroyed; the windowed
driver discards such a step and replays it after growing the particle
arrays, so no run it drives loses charge.

Kernel backends resolve through the port's dispatcher at the local grid
shape, as the single-device step resolves at its own (the reference
resolves every shard-body backend to ``xla``, having no Pallas inside
`shard_map`).

Over several processes (`repro_torch.distributed.ranks`) each rank holds a
contiguous block ``[BX, BY, ...]`` of the stack, and ``DistConfig.ranks``
(a `RankGrid`) carries the rank grid: `ring_shift` swaps the block's edge
slab with the neighbour rank, `psum_all` / `pmax_all` reduce the gathered
``[SX, SY]`` values as the stack does, and the shard body is unchanged; it
runs once a local shard. ``ranks=None`` is the one-process stack.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.binning import (
    BinnedLayout,
    BinSlab,
    bin_slab_staging,
    build_bin_slab,
    build_bins,
    cell_index,
    sort_permutation,
)
from repro_torch.core.deposition import CURRENT_STAGGER, deposit_current_matrix_fused, deposit_matrix
from repro_torch.core.gather import EB_STAGGERS, gather_fields_fused, gather_matrix
from repro_torch.core.gpma import gpma_update
from repro_torch.core.shape_functions import max_guard
from repro_torch.distributed.comm import CommSpec
from repro_torch.distributed.compression import (
    MIG_ROW_BYTES_COMPRESSED,
    MIG_ROW_BYTES_EXACT,
    pack_momenta,
    pack_positions,
    unpack_momenta,
    unpack_positions,
)
from repro_torch.kernels import dispatch
from repro_torch.pic.grid import GridSpec
from repro_torch.pic.maxwell import curl_b_padded, curl_e_padded
from repro_torch.pic.plasma import ParticleState
from repro_torch.pic.pusher import advance_positions, boris_push, lorentz_gamma

__all__ = [
    "DistConfig",
    "DistState",
    "STAT_KEYS",
    "build_local_bins",
    "dist_global_sort_device",
    "dist_pic_step",
    "halo_extend",
    "halo_extend_overlapped",
    "halo_extend_periodic_local",
    "halo_reduce",
    "halo_reduce_overlapped",
    "halo_reduce_periodic_local",
    "in_domain",
    "make_pic_mesh",
    "migrate_axis",
    "partition_particles",
    "PicMesh",
    "pmax_all",
    "psum_all",
    "ring_shift",
    "validate_shard_guard",
]

#: the shard axes of every stacked tensor
SHARD_X, SHARD_Y = 0, 1


# -- collectives on the shard stack ----------------------------------------------


def ring_shift(t: torch.Tensor, axis: int, shift: int, ranks=None) -> torch.Tensor:
    """``lax.ppermute(t, axis_name, _ring(axis_name, shift))`` on a stack:
    with ``shift=+1`` shard j receives shard j - 1's block (periodic), with
    ``-1`` shard j + 1's. uint16 blocks travel as their int16 bits. With a
    rank grid ``t`` is this rank's block, and the slab that crosses a
    block's edge comes from the neighbour rank."""
    if t.dtype == torch.uint16:
        return ring_shift(t.view(torch.int16), axis, shift, ranks).view(torch.uint16)
    if ranks is None:
        return torch.roll(t, shifts=shift, dims=axis)
    return ranks.ring_shift(t, axis, shift)


def gather_shards(per_shard: torch.Tensor, ranks=None) -> torch.Tensor:
    """A per-shard value ``[BX, BY, ...]`` of this rank's block as the whole
    mesh's ``[SX, SY, ...]`` (the block itself without a rank grid)."""
    return per_shard if ranks is None else ranks.gather(per_shard)


def psum_all(per_shard: torch.Tensor, ranks=None) -> torch.Tensor:
    """Sum of a per-shard value ``[SX, SY]`` over the mesh (the gathered
    values summed as the stack sums them, so a float total is the one
    process's bit for bit)."""
    return gather_shards(per_shard, ranks).sum(dim=(SHARD_X, SHARD_Y))


def pmax_all(per_shard: torch.Tensor, ranks=None) -> torch.Tensor:
    """Max of a per-shard value ``[SX, SY]`` over the mesh."""
    return gather_shards(per_shard, ranks).amax(dim=(SHARD_X, SHARD_Y))


def n_mesh_shards(local_shards: int, ranks=None) -> int:
    """The mesh's shard count, from this rank's."""
    return local_shards * (1 if ranks is None else ranks.world)


# -- halos -------------------------------------------------------------------------
#
# A stacked field is [SX, SY, ..., nx, ny, nz]: the local axes are its last
# three, ``axis`` 0, 1, 2 below.


def _dim(axis: int) -> int:
    return axis - 3


def halo_extend(f, g: int, axis: int, shard_axis: int, ranks=None):
    """Extend each shard's block by g cells on both sides of ``axis`` with
    its neighbours' slabs along ``shard_axis``."""
    d = _dim(axis)
    n = f.shape[d]
    lo, hi = f.narrow(d, 0, g), f.narrow(d, n - g, g)
    return torch.cat([ring_shift(hi, shard_axis, +1, ranks), f, ring_shift(lo, shard_axis, -1, ranks)], dim=d)


def halo_extend_periodic_local(f, g: int, axis: int):
    """The local periodic extension (the undecomposed z axis)."""
    d = _dim(axis)
    n = f.shape[d]
    return torch.cat([f.narrow(d, n - g, g), f, f.narrow(d, 0, g)], dim=d)


def _fold(core, g: int, d: int, from_lo, from_hi):
    """core with ``from_lo`` added onto its first g cells along ``d``, then
    ``from_hi`` onto its last g (in that order: the slabs overlap on a
    block narrower than 2g)."""
    n = core.shape[d]
    core.narrow(d, 0, g).add_(from_lo)
    core.narrow(d, n - g, g).add_(from_hi)
    return core


def halo_reduce(fpad, g: int, axis: int, shard_axis: int, ranks=None):
    """Fold each shard's guard contributions along ``axis`` onto its
    neighbours' cores (the reverse of `halo_extend`): the result is 2g
    cells narrower there."""
    d = _dim(axis)
    n = fpad.shape[d] - 2 * g
    lo_guard, hi_guard = fpad.narrow(d, 0, g), fpad.narrow(d, g + n, g)
    core = fpad.narrow(d, g, n).clone()
    return _fold(core, g, d, ring_shift(hi_guard, shard_axis, +1, ranks), ring_shift(lo_guard, shard_axis, -1, ranks))


def halo_reduce_periodic_local(fpad, g: int, axis: int):
    d = _dim(axis)
    n = fpad.shape[d] - 2 * g
    core = fpad.narrow(d, g, n).clone()
    return _fold(core, g, d, fpad.narrow(d, g + n, g), fpad.narrow(d, 0, g))


# The overlapped exchange re-expresses the serialized one's region map so
# that every first-hop slab is sliced from the raw block: no exchange waits
# on another. A ring shift is pure routing, and the reduce keeps the
# serialized per-element float add grouping, so both are bit-equal to the
# serialized exchange.


def _hops(ranks):
    """The ring shifts along shard x and y, one slab ``t`` by ``shift``."""
    return (lambda t, shift: ring_shift(t, SHARD_X, shift, ranks),
            lambda t, shift: ring_shift(t, SHARD_Y, shift, ranks))


def halo_extend_overlapped(f, g: int, ranks=None):
    """Extend by g cells along x and y in one round: edge slabs from the raw
    block; the four g x g corners as two hops, x then y, of the corner block
    (the serialized path ships them inside its y slabs: same values, same
    route). The caller applies the z extension last, as the serialized
    x -> y -> z order does."""
    nx, ny = f.shape[-3], f.shape[-2]
    hx, hy = _hops(ranks)
    row_top = hx(f[..., nx - g:, :, :], +1)
    row_bot = hx(f[..., :g, :, :], -1)
    col_left = hy(f[..., :, ny - g:, :], +1)
    col_right = hy(f[..., :, :g, :], -1)
    c_tl = hy(hx(f[..., nx - g:, ny - g:, :], +1), +1)
    c_tr = hy(hx(f[..., nx - g:, :g, :], +1), -1)
    c_bl = hy(hx(f[..., :g, ny - g:, :], -1), +1)
    c_br = hy(hx(f[..., :g, :g, :], -1), -1)
    top = torch.cat([c_tl, row_top, c_tr], dim=-2)
    mid = torch.cat([col_left, f, col_right], dim=-2)
    bot = torch.cat([c_bl, row_bot, c_br], dim=-2)
    return torch.cat([top, mid, bot], dim=-3)


def halo_reduce_overlapped(zf, g: int, ranks=None):
    """Fold the x and y guard contributions onto the neighbours' cores in
    one round. ``zf`` is the padded deposition grid after the local z fold,
    (..., nx + 2g, ny + 2g, nz); returns the (..., nx, ny, nz) core.

    Bit-equality with the serialized z -> y -> x fold rests on the add
    grouping: the serialized x phase ships guard rows whose corner columns
    already hold the received y contribution, so the four corner pieces are
    summed before their x hop, and every destination element sees
    ``(zf + recv_y) + recv_x``. Needs nx, ny >= 2g; `_reduce_all` takes the
    serialized fold below that."""
    nx, ny = zf.shape[-3] - 2 * g, zf.shape[-2] - 2 * g
    hx, hy = _hops(ranks)
    recv_y_hi = hy(zf[..., :, ny + g:, :], +1)
    recv_y_lo = hy(zf[..., :, :g, :], -1)
    recv_x_hi_mid = hx(zf[..., nx + g:, 2 * g:ny, :], +1)
    recv_x_lo_mid = hx(zf[..., :g, 2 * g:ny, :], -1)
    hi_l = zf[..., nx + g:, g:2 * g, :] + recv_y_hi[..., nx + g:, :, :]
    hi_r = zf[..., nx + g:, ny:ny + g, :] + recv_y_lo[..., nx + g:, :, :]
    lo_l = zf[..., :g, g:2 * g, :] + recv_y_hi[..., :g, :, :]
    lo_r = zf[..., :g, ny:ny + g, :] + recv_y_lo[..., :g, :, :]
    recv_x_hi = torch.cat([hx(hi_l, +1), recv_x_hi_mid, hx(hi_r, +1)], dim=-2)
    recv_x_lo = torch.cat([hx(lo_l, -1), recv_x_lo_mid, hx(lo_r, -1)], dim=-2)
    # the destination adds in the serialized order: interior, +y, +x
    out = zf[..., g:nx + g, g:ny + g, :].clone()
    out[..., :, :g, :] += recv_y_hi[..., g:nx + g, :, :]
    out[..., :, ny - g:, :] += recv_y_lo[..., g:nx + g, :, :]
    out[..., :g, :, :] += recv_x_hi
    out[..., nx - g:, :, :] += recv_x_lo
    return out


# -- particle migration -------------------------------------------------------------
#
# Particle tensors are [..., N, ...rest] with the particle axis at
# ``mask.dim() - 1``; every leading axis is a shard axis.


def _take_rows(a, idx):
    """Rows ``idx`` [..., K] of ``a`` [..., N, *rest] along the particle
    axis."""
    p = idx.dim() - 1
    rest = a.shape[p + 1:]
    return torch.gather(a, p, idx.reshape(idx.shape + (1,) * len(rest)).expand(idx.shape + rest))


def _put_rows(a, idx, rows):
    """``a`` with rows ``idx`` replaced by ``rows`` (out of place)."""
    p = idx.dim() - 1
    rest = a.shape[p + 1:]
    return a.scatter(p, idx.reshape(idx.shape + (1,) * len(rest)).expand(idx.shape + rest), rows)


def first_of_stable_order(mask, k: int):
    """The first k entries (at most the row's length) of each row's stable
    order that puts the indices where ``mask`` holds first: exactly
    ``torch.argsort(~mask, dim=-1, stable=True)[..., :k]``, without a sort.
    Each row's running count of its True and of its False entries is one
    prefix sum over the whole flattened mask (a row-wise scan of a few very
    long rows is slow on the card); the j-th selected index is where a
    count first reaches its rank, a binary search."""
    n = mask.shape[-1]
    k = min(k, n)
    i32 = dict(dtype=torch.int32, device=mask.device)
    ones = mask.to(torch.int32)
    running = torch.cumsum(ones.reshape(-1), dim=0, dtype=torch.int32).reshape(mask.shape)
    n_true_before = running - (running[..., :1] - ones[..., :1])  # each row's own inclusive count
    n_false_before = torch.arange(1, n + 1, **i32) - n_true_before
    n_true = n_true_before[..., -1:]
    rank = torch.arange(1, k + 1, **i32).expand(mask.shape[:-1] + (k,))
    of_true = torch.searchsorted(n_true_before, rank.contiguous())
    of_false = torch.searchsorted(n_false_before, torch.clamp_min(rank - n_true, 1).contiguous())
    return torch.where(rank <= n_true, of_true, of_false)


def _pack(mask, arrays, cap: int):
    """Each shard's masked rows packed into a buffer of ``cap`` rows, in
    index order. Returns (bufs, valid, selected mask, overflow a shard)."""
    sel = first_of_stable_order(mask, cap)
    valid = torch.gather(mask, -1, sel)
    bufs = [_take_rows(a, sel) for a in arrays]
    selected = torch.zeros_like(mask).scatter(-1, sel, valid)
    n_overflow = mask.sum(-1) - valid.sum(-1)
    return bufs, valid, selected, n_overflow


def _insert(arrays, alive, bufs, valid):
    """Buffer rows into each shard's dead slots, lowest index first.
    Returns the arrays, ``alive``, the count a shard of received particles
    that found no dead slot (destroyed: the caller surfaces it as
    ``mig_recv_dropped``) and the mask of indices that received an arrival
    (an arrival may reuse a just-departed index whose stale slot maps its
    own cell, which GPMA's churn count cannot see)."""
    dst = first_of_stable_order(~alive, valid.shape[-1])  # dead slots, lowest index first
    was_alive = torch.gather(alive, -1, dst)
    can = ~was_alive & valid
    n_dropped = valid.sum(-1) - can.sum(-1)
    out = []
    for cur, buf in zip(arrays, bufs):
        # a row that lands nowhere rewrites its slot with what it holds
        lands = can.reshape(can.shape + (1,) * (buf.dim() - can.dim()))
        out.append(_put_rows(cur, dst, torch.where(lands, buf, _take_rows(cur, dst))))
    alive = alive.scatter(-1, dst, was_alive | can)
    inserted = torch.zeros_like(alive).scatter(-1, dst, can)
    return out, alive, n_dropped, inserted


def _into_range(pos, coord: int, extent: int):
    """Received rows with their ``coord`` clipped into the receiver's
    [0, extent): ``x + extent`` of a particle a hair below 0 rounds to
    ``extent`` (and a compressed coordinate dequantizes up to one step
    outside the range), where the receiver would hold the arrival out of
    its domain for a step, neither pushed nor deposited."""
    top = torch.nextafter(torch.tensor(float(extent), dtype=pos.dtype), torch.tensor(0.0, dtype=pos.dtype)).item()
    out = pos.clone()
    out[..., coord] = out[..., coord].clamp(0.0, top)
    return out


def migrate_axis(pos, u, w, alive, *, coord: int, extent: int, shard_axis: int, mig_cap: int, local_shape=None,
                 compress: bool = False, ranks=None):
    """Exchange the particles out of range along one decomposed axis with
    the neighbouring shards along ``shard_axis``.

    Returns ``(pos, u, w, alive, n_send_overflow, n_recv_dropped,
    arrived)``, the counts per shard: a send-side overflow stays resident,
    out of range, and must be masked until it migrates; a receive-side drop
    is a destroyed particle; ``arrived`` marks the indices that received a
    particle.

    ``compress`` (``comm.compress_migration``) packs the buffers before the
    exchange and unpacks them after: positions (shard-relative after the
    shift below) as uint16 fixed point over ``local_shape``, momenta as
    bfloat16, weights exact. Invalid buffer rows cross as garbage and are
    never inserted.

    Arrivals are clipped into the receiver's range along ``coord``
    (`_into_range`); the reference leaves a rounded one out of range. With
    a rank grid (``ranks``) the buffers of a block's edge shards cross to
    the neighbour rank."""
    x = pos[..., coord]
    go_hi = alive & (x >= extent)
    go_lo = alive & (x < 0)
    bufs_hi, valid_hi, sel_hi, of_hi = _pack(go_hi, [pos, u, w], mig_cap)
    bufs_lo, valid_lo, sel_lo, of_lo = _pack(go_lo, [pos, u, w], mig_cap)
    # into the receiver's local frame
    for bufs, delta in ((bufs_hi, -float(extent)), (bufs_lo, float(extent))):
        shifted = bufs[0].clone()
        shifted[..., coord] += delta
        bufs[0] = shifted
    alive = alive & ~(sel_hi | sel_lo)

    if compress:
        def pack(b):
            return [pack_positions(b[0], local_shape), pack_momenta(b[1]), b[2]]
        bufs_hi, bufs_lo = pack(bufs_hi), pack(bufs_lo)

    recv_prev = [ring_shift(b, shard_axis, +1, ranks) for b in bufs_hi]
    recv_valid_prev = ring_shift(valid_hi, shard_axis, +1, ranks)
    recv_next = [ring_shift(b, shard_axis, -1, ranks) for b in bufs_lo]
    recv_valid_next = ring_shift(valid_lo, shard_axis, -1, ranks)

    if compress:
        def unpack(b):
            return [unpack_positions(b[0], local_shape, pos.dtype), unpack_momenta(b[1], u.dtype), b[2]]
        recv_prev, recv_next = unpack(recv_prev), unpack(recv_next)
    recv_prev[0], recv_next[0] = _into_range(recv_prev[0], coord, extent), _into_range(recv_next[0], coord, extent)

    arrays, alive, drop1, ins1 = _insert([pos, u, w], alive, recv_prev, recv_valid_prev)
    arrays, alive, drop2, ins2 = _insert(arrays, alive, recv_next, recv_valid_next)
    pos, u, w = arrays
    return pos, u, w, alive, of_hi + of_lo, drop1 + drop2, ins1 | ins2


# -- configuration ------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """The shard step's configuration (the reference's fields).
    ``local_grid`` is one shard's block; ``x_axes`` / ``y_axes`` name the
    mesh axes splitting grid x and y, one each: the port's mesh is two shard
    axes, and a chain of several mesh axes on one grid axis is refused.
    ``ranks`` (a `repro_torch.distributed.ranks.RankGrid`) is the rank grid
    when the stack is spread over processes, each holding its block; None
    is the one-process stack."""

    local_grid: GridSpec
    dt: float
    order: int = 1
    deposition: str = "matrix"    # matrix (fused) | matrix_unfused
    gather: str = "matrix"        # matrix (fused) | matrix_unfused
    backend: str = "auto"         # auto | torch | cuda | cuda_reduced (or a reference name)
    charge: float = -1.0
    mass: float = 1.0
    capacity: int = 16
    mig_cap: int = 256
    x_axes: tuple = ("data",)
    y_axes: tuple = ("model",)
    comm: CommSpec = CommSpec()
    ranks: object = None

    def __post_init__(self):
        validate_shard_guard(self.local_grid, self.order)
        if self.deposition not in ("matrix", "matrix_unfused"):
            raise ValueError(f"DistConfig.deposition must be 'matrix' or 'matrix_unfused', got {self.deposition!r} "
                             "(the distributed step is bin-based; scatter/rhocell modes are single-device only)")
        if self.gather not in ("matrix", "matrix_unfused"):
            raise ValueError(f"DistConfig.gather must be 'matrix' or 'matrix_unfused', got {self.gather!r} "
                             "(the distributed step gathers through the bins; scatter gather is single-device only)")
        object.__setattr__(self, "x_axes", tuple(self.x_axes))
        object.__setattr__(self, "y_axes", tuple(self.y_axes))
        if len(self.x_axes) != 1 or len(self.y_axes) != 1:
            raise NotImplementedError(f"DistConfig x_axes={self.x_axes}, y_axes={self.y_axes}: the port's mesh is "
                                      "two shard axes, one mesh axis per grid axis (ROADMAP, queue C)")
        object.__setattr__(self, "backend", dispatch.canonical(self.backend))

    @property
    def guard(self) -> int:
        return max_guard(self.order)

    @property
    def needs_slab(self) -> bool:
        """Whether the step rebuilds the carried slab (a fused kernel
        consumes it); a pure-unfused configuration carries it unchanged."""
        return self.deposition == "matrix" or self.gather == "matrix"


def validate_shard_guard(local_grid: GridSpec, order: int) -> None:
    """Refuse a local block narrower than the guard on any axis: the halo
    slabs would wrap into the neighbour's neighbour, giving wrong fields and
    currents with no error."""
    g = max_guard(order)
    smallest = min(local_grid.shape)
    if g > smallest:
        raise ValueError(
            f"guard width {g} (deposition order {order}) exceeds the smallest local shard extent {smallest} "
            f"(local grid {local_grid.shape}): halo slabs would wrap into the neighbor's neighbor. Use shards of "
            f"at least {g} cells per axis — at order {order} that means local_grid.shape >= ({g}, {g}, {g}).")


def _extend_all(f, g: int, cfg: DistConfig):
    if cfg.comm.overlap_halo:
        f = halo_extend_overlapped(f, g, cfg.ranks)
    else:
        f = halo_extend(halo_extend(f, g, 0, SHARD_X, cfg.ranks), g, 1, SHARD_Y, cfg.ranks)
    return halo_extend_periodic_local(f, g, 2)


def _reduce_all(fpad, g: int, cfg: DistConfig):
    fpad = halo_reduce_periodic_local(fpad, g, 2)
    nx, ny = cfg.local_grid.shape[0], cfg.local_grid.shape[1]
    if cfg.comm.overlap_halo and nx >= 2 * g and ny >= 2 * g:
        return halo_reduce_overlapped(fpad, g, cfg.ranks)
    return halo_reduce(halo_reduce(fpad, g, 1, SHARD_Y, cfg.ranks), g, 0, SHARD_X, cfg.ranks)


def in_domain(pos, shape):
    """Particles whose local position lies in the shard's block along x and
    y (z wraps locally). A send-side overflow stays resident out of range:
    everything bin- or weight-based masks on this."""
    x, y = pos[..., 0], pos[..., 1]
    return (x >= 0) & (x < shape[0]) & (y >= 0) & (y < shape[1])


# -- the step -------------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistState:
    """The distributed state on the shard stack (layouts in the module
    docstring). ``mid_pos`` / ``mid_u``: the last step's push output, right
    before migration, which a replay after a receive-side drop starts
    from."""

    fields: torch.Tensor
    pos: torch.Tensor
    u: torch.Tensor
    w: torch.Tensor
    alive: torch.Tensor
    slots: torch.Tensor
    pslot: torch.Tensor
    slab_d: torch.Tensor
    slab_valid: torch.Tensor
    mid_pos: torch.Tensor
    mid_u: torch.Tensor


STAT_KEYS = (
    "n_moved", "n_overflow", "n_empty", "mig_send_overflow", "mig_recv_dropped", "n_unmigrated", "n_alive",
    "n_migrated", "mig_payload_bytes", "max_shard_alive",
)


def _shards(t: torch.Tensor):
    """The shard blocks of a stacked tensor, row-major: ``t[a, b]``."""
    return [t[a, b] for a in range(t.shape[0]) for b in range(t.shape[1])]


def _stack(blocks, sx: int, sy: int) -> torch.Tensor:
    """Per-shard blocks, row-major, back onto the stack."""
    out = torch.stack(blocks)
    return out.reshape((sx, sy) + out.shape[1:])


def dist_pic_step(state: DistState, cfg: DistConfig, *, use_mid=None):
    """One step of every shard. Returns ``(new state, stats)``: the new
    state in fresh tensors (its ``mid_pos`` / ``mid_u`` the step's
    post-push, pre-migration snapshot), ``stats`` the mesh totals of
    `STAT_KEYS` as 0-d int64 tensors (``max_shard_alive`` a max).

    ``use_mid`` (a 0-d bool tensor; the window's replay after a receive-side
    drop): the carried ``state.mid_pos`` / ``state.mid_u`` replace this
    step's push output, so the replayed migration has the discarded step's
    inputs bit for bit (weights and ``alive`` are not touched by the push).
    """
    sx, sy = state.pos.shape[:2]
    g = cfg.guard
    shape = cfg.local_grid.shape
    cap = state.slots.shape[-1]
    pos, u, w, alive = state.pos, state.u, state.w, state.alive
    layouts = [BinnedLayout(slots=s, particle_slot=p) for s, p in zip(_shards(state.slots), _shards(state.pslot))]

    # send-side stragglers of the previous step: alive, out of range, in
    # no bin (the gather gives them 0), frozen this step
    resident = alive & in_domain(pos, shape)

    # 1. the six halo-extended components, shard-major: each shard's
    #    (6, nx+2g, ny+2g, nz+2g) block contiguous for the gather
    with record_function("pic.halo"):
        padded = _extend_all(state.fields.permute(1, 2, 0, 3, 4, 5), g, cfg).contiguous()
    e_rows, b_rows = [], []
    with record_function("pic.gather"):
        for k, (layout, pad_s, pos_s) in enumerate(zip(layouts, _shards(padded), _shards(pos))):
            if cfg.gather == "matrix":
                slab = BinSlab(d=state.slab_d[k // sy, k % sy], valid=state.slab_valid[k // sy, k % sy])
                e_p, b_p = gather_fields_fused(slab, pad_s, layout, grid_shape=shape, order=cfg.order,
                                               backend=cfg.backend)
            else:
                comps = [gather_matrix(pos_s, pad_s[c], layout, grid_shape=shape, order=cfg.order, stagger=stagger,
                                       backend=cfg.backend) for c, stagger in enumerate(EB_STAGGERS)]
                e_p, b_p = torch.stack(comps[:3], dim=-1), torch.stack(comps[3:], dim=-1)
            e_rows.append(e_p)
            b_rows.append(b_p)
        e_p, b_p = _stack(e_rows, sx, sy), _stack(b_rows, sx, sy)

    # 2. push (positions not wrapped along x, y: out of range migrates);
    #    frozen particles keep position and momentum
    with record_function("pic.push"):
        res = resident[..., None]
        u_new = torch.where(res, boris_push(u, e_p, b_p, cfg.charge / cfg.mass, cfg.dt), u)
        pos_new = torch.where(res, advance_positions(pos, u_new, cfg.dt, cfg.local_grid.dx), pos)
        nz = torch.full((1,), float(shape[2]), dtype=pos.dtype, device=pos.device)
        pos_new = torch.cat([pos_new[..., :2], torch.remainder(pos_new[..., 2:], nz)], dim=-1)
        if use_mid is not None:
            pos_new = torch.where(use_mid, state.mid_pos, pos_new)
            u_new = torch.where(use_mid, state.mid_u, u_new)
    mid_pos, mid_u = pos_new, u_new

    # 3. migration, x then y
    send_overflow = torch.zeros((sx, sy), dtype=torch.int64, device=pos.device)
    recv_dropped = torch.zeros_like(send_overflow)
    arrived = torch.zeros_like(alive)
    for coord, shard_axis in ((0, SHARD_X), (1, SHARD_Y)):
        with record_function("pic.migrate"):
            pos_new, u_new, w, alive, of, dr, ins = migrate_axis(
                pos_new, u_new, w, alive, coord=coord, extent=shape[coord], shard_axis=shard_axis,
                mig_cap=cfg.mig_cap, local_shape=shape, compress=cfg.comm.compress_migration, ranks=cfg.ranks)
            send_overflow = send_overflow + of
            recv_dropped = recv_dropped + dr
            arrived = arrived | ins

    # 4. the incremental sort of each shard's bins; stragglers stay out
    with record_function("pic.gpma"):
        binned = alive & in_domain(pos_new, shape)
        new_cells = cell_index(pos_new, shape)
        # an arrival on a just-departed index whose stale slot maps the
        # arrival's own cell looks stationary to gpma_update: a boundary
        # crossing is one move whichever shard sees it, so count it here
        stale_cell = torch.where(state.pslot >= 0, state.pslot.long() // cap, -1)
        invisible = torch.sum(arrived & binned & (new_cells == stale_cell), dim=-1)
        new_layouts, gstats = [], []
        for layout, cells_s, binned_s in zip(layouts, _shards(new_cells), _shards(binned)):
            layout, st = gpma_update(layout, cells_s, binned_s)
            new_layouts.append(layout)
            gstats.append(st)
        slots = _stack([lay.slots for lay in new_layouts], sx, sy)
        pslot = _stack([lay.particle_slot for lay in new_layouts], sx, sy)
        # ...and arrivals whose first insert found a full bin: the crossing
        # happened this step (a nonzero overflow sorts this very step)
        invisible = invisible + torch.sum(arrived & binned & (stale_cell < 0) & (pslot < 0), dim=-1)

    # 5. deposition inputs at x^{n+1}, v^{n+1/2} (binned particles only)
    gamma = lorentz_gamma(u_new)
    v = u_new / gamma[..., None]
    qw = cfg.charge * w * binned.to(w.dtype)
    slab_rows, valid_rows, j_rows = [], [], []
    for k, (layout, pos_s, v_s, qw_s) in enumerate(zip(new_layouts, _shards(pos_new), _shards(v), _shards(qw))):
        a, b = k // sy, k % sy
        values = None
        with record_function("pic.staging"):
            if cfg.deposition == "matrix":
                slab, values = bin_slab_staging(pos_s, v_s, qw_s, layout, grid_shape=shape)
            elif cfg.needs_slab:
                slab = build_bin_slab(pos_s, layout, grid_shape=shape)
            else:  # nothing consumes the slab: carried unchanged
                slab = BinSlab(d=state.slab_d[a, b].clone(), valid=state.slab_valid[a, b].clone())
        with record_function("pic.deposit"):
            if cfg.deposition == "matrix":
                j3 = deposit_current_matrix_fused(pos_s, v_s, qw_s, layout, grid_shape=shape, order=cfg.order,
                                                  backend=cfg.backend, slab=slab, values=values)
            else:
                j3 = [deposit_matrix(pos_s, qw_s * v_s[:, c], layout, grid_shape=shape, order=cfg.order,
                                     stagger=stagger, backend=cfg.backend)
                      for c, stagger in enumerate(CURRENT_STAGGER)]
        slab_rows.append(slab.d)
        valid_rows.append(slab.valid)
        j_rows.append(torch.stack(j3))
    inv_vol = 1.0 / cfg.local_grid.cell_volume
    with record_function("pic.fold"):
        j = _reduce_all(_stack(j_rows, sx, sy), g, cfg) * inv_vol  # [SX, SY, 3, nx, ny, nz]

    # 6. Maxwell on 1-cell halos, B-E-B leapfrog
    dx, dt = cfg.local_grid.dx, cfg.dt

    def half_b(e3, b3, dt_half):
        cx, cy, cz = curl_e_padded(*(_extend_all(f, 1, cfg) for f in e3), 1, shape, dx)
        return b3[0] - dt_half * cx, b3[1] - dt_half * cy, b3[2] - dt_half * cz

    with record_function("pic.maxwell"):
        ex, ey, ez, bx, by, bz = state.fields.unbind(0)
        b1 = half_b((ex, ey, ez), (bx, by, bz), 0.5 * dt)
        cx, cy, cz = curl_b_padded(*(_extend_all(f, 1, cfg) for f in b1), 1, shape, dx)
        e1 = (ex + dt * (cx - j[:, :, 0]), ey + dt * (cy - j[:, :, 1]), ez + dt * (cz - j[:, :, 2]))
        b2 = half_b(e1, b1, 0.5 * dt)
        fields = torch.stack([*e1, *b2])

    # per-step communication accounting: every migrate_axis call ships
    # 2 directions x mig_cap rows whatever their occupancy
    row_bytes = MIG_ROW_BYTES_COMPRESSED if cfg.comm.compress_migration else MIG_ROW_BYTES_EXACT
    per_shard = lambda vals: _stack(vals, sx, sy)
    # the per-shard counters in one [SX, SY, 8] gather (one collective over
    # ranks); integer totals, exact in any order
    counters = {
        "n_moved": per_shard([s.n_moved for s in gstats]) + invisible,
        "n_overflow": per_shard([s.n_overflow for s in gstats]),
        "n_empty": per_shard([s.n_empty for s in gstats]),
        "mig_send_overflow": send_overflow,
        "mig_recv_dropped": recv_dropped,
        "n_unmigrated": torch.sum(alive & ~in_domain(pos_new, shape), dim=-1),
        "n_alive": torch.sum(alive, dim=-1),
        "n_migrated": torch.sum(arrived, dim=-1),
    }
    mesh = gather_shards(torch.stack([v.to(torch.int64) for v in counters.values()], dim=-1), cfg.ranks)
    stats = dict(zip(counters, psum_all(mesh).unbind(-1)))
    stats["mig_payload_bytes"] = torch.full((), 2 * cfg.mig_cap * row_bytes * 2 * n_mesh_shards(sx * sy, cfg.ranks),
                                            dtype=torch.int64, device=pos.device)
    stats["max_shard_alive"] = pmax_all(mesh[..., list(counters).index("n_alive")])
    new = DistState(fields=fields, pos=pos_new, u=u_new, w=w, alive=alive, slots=slots, pslot=pslot,
                    slab_d=_stack(slab_rows, sx, sy), slab_valid=_stack(valid_rows, sx, sy), mid_pos=mid_pos,
                    mid_u=mid_u)
    return new, stats


def dist_global_sort_device(pos, u, w, alive, cfg: DistConfig):
    """Each shard's global sort: its particles permuted into cell order, its
    bins and slab rebuilt at ``cfg.capacity``. Send-side stragglers (alive,
    out of range) sort to the back with the dead and stay out of the bins,
    alive. Returns ``(pos, u, w, alive, slots, pslot, slab_d, slab_valid,
    overflow)``, the overflow summed over the shards (a 0-d tensor)."""
    sx, sy = pos.shape[:2]
    shape = cfg.local_grid.shape
    outs = []
    for pos_s, u_s, w_s, alive_s in zip(_shards(pos), _shards(u), _shards(w), _shards(alive)):
        binned = alive_s & in_domain(pos_s, shape)
        perm = sort_permutation(cell_index(pos_s, shape), binned)
        pos_s, u_s, w_s, alive_s = pos_s[perm], u_s[perm], w_s[perm], alive_s[perm]
        binned = alive_s & in_domain(pos_s, shape)
        layout, overflow = build_bins(cell_index(pos_s, shape), binned, n_cells=cfg.local_grid.n_cells,
                                      capacity=cfg.capacity)
        slab = build_bin_slab(pos_s, layout, grid_shape=shape)
        outs.append((pos_s, u_s, w_s, alive_s, layout.slots, layout.particle_slot, slab.d, slab.valid, overflow))
    cols = list(zip(*outs))
    overflow = psum_all(_stack([o.to(torch.int64) for o in cols[8]], sx, sy), cfg.ranks)
    return (*(_stack(list(c), sx, sy) for c in cols[:8]), overflow)


# -- the reference's functional builders --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PicMesh:
    """The port's mesh (the reference's ``jax.sharding.Mesh`` of
    `make_pic_mesh`): ``sx x sy`` shards along grid x and y, and the rank
    grid when they are spread over processes (None: every shard in this
    process). ``block`` is the ``(bx, by)`` shards this process holds."""

    sx: int
    sy: int
    ranks: object = None

    @property
    def shape(self) -> tuple[int, int]:
        return self.sx, self.sy

    @property
    def block(self) -> tuple[int, int]:
        if self.ranks is None:
            return self.sx, self.sy
        return self.sx // self.ranks.px, self.sy // self.ranks.py


def make_pic_mesh(sx: int, sy: int, group=None) -> PicMesh:
    """The ``sx x sy`` mesh: its shards all in this process (``group``
    None, or a group of one rank), or spread over the ranks of a
    `torch.distributed` process group, each rank a contiguous block on the
    group's device, the rank grid the x-first choice
    (`repro_torch.distributed.ranks`). A rank count with no grid that
    divides the mesh is refused by name. Counterpart of
    `repro.pic.dist_simulation.make_pic_mesh`."""
    import torch.distributed as dist

    sx, sy = mesh_pair((sx, sy))
    if group is None or dist.get_world_size(group) == 1:
        return PicMesh(sx, sy)
    from repro_torch.distributed.ranks import RankGrid

    return PicMesh(sx, sy, RankGrid.of_group(sx, sy, group))


def mesh_pair(mesh) -> tuple[int, int]:
    """A mesh of the port: a `PicMesh`, or the pair ``(sx, sy)`` of shard
    counts along grid x and y (the reference's ``jax.sharding.Mesh``, whose
    devices the port stacks on one device or spreads over ranks). Anything
    else is refused."""
    if isinstance(mesh, PicMesh):
        return mesh.shape
    if (isinstance(mesh, (tuple, list)) and len(mesh) == 2
            and all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) and v > 0 for v in mesh)):
        return int(mesh[0]), int(mesh[1])
    raise TypeError(f"a mesh in the port is a PicMesh or the pair (sx, sy) of shard counts, got {mesh!r}: the "
                    "port takes no jax.sharding.Mesh")


def as_pic_mesh(mesh) -> PicMesh:
    """A `PicMesh`, or a pair ``(sx, sy)`` as the one-process mesh."""
    return mesh if isinstance(mesh, PicMesh) else PicMesh(*mesh_pair(mesh))


def _check_stack(t: torch.Tensor, sx: int, sy: int, name: str) -> None:
    if tuple(t.shape[:2]) != (sx, sy):
        raise ValueError(f"{name} has shard axes {tuple(t.shape[:2])}, not the mesh's ({sx}, {sy})")


def dist_pic_step_local(fields, pos, u, w, alive, slots, particle_slot, slab_d, slab_valid, cfg: DistConfig, *,
                        mid_pos=None, mid_u=None, use_mid=None):
    """The reference's shard body with its flat arguments and outputs, run
    over the whole shard stack at once (the port's collectives are
    operations on the stack, `dist_pic_step`). ``fields`` are the six
    components' shard blocks, ``[SX, SY, nx, ny, nz]`` each; the particle
    arrays carry the two shard axes first. ``use_mid`` (a 0-d bool tensor)
    replaces the step's push output by ``mid_pos`` / ``mid_u``. Returns
    ``(fields, pos, u, w, alive, slots, pslot, slab_d, slab_valid, mid_pos,
    mid_u, stats)``: the six blocks as a tuple, the post-push snapshot, and
    the mesh totals of `STAT_KEYS`."""
    state = DistState(fields=torch.stack(list(fields)), pos=pos, u=u, w=w, alive=alive, slots=slots,
                      pslot=particle_slot, slab_d=slab_d, slab_valid=slab_valid,
                      mid_pos=torch.zeros_like(pos) if mid_pos is None else mid_pos,
                      mid_u=torch.zeros_like(u) if mid_u is None else mid_u)
    new, stats = dist_pic_step(state, cfg, use_mid=use_mid)
    return (tuple(new.fields.unbind(0)), new.pos, new.u, new.w, new.alive, new.slots, new.pslot, new.slab_d,
            new.slab_valid, new.mid_pos, new.mid_u, stats)


def make_dist_step(mesh, cfg: DistConfig):
    """The reference's per-step builder: a function of ``(fields6, pos, u,
    w, alive, slots, pslot, slab_d, slab_valid)`` returning the same nine,
    and the `STAT_KEYS` dict of 0-d tensors (mesh totals). ``fields6`` are
    the six global (NX, NY, NZ) components, the particle arrays ``[SX, SY,
    ...]`` shard stacks; ``mesh`` is the pair ``(sx, sy)`` or a `PicMesh`.
    Over ranks every argument is the rank's block (its shards' stacks, and
    the part of the grid they cover) and the totals are the mesh's. The
    step writes none of its inputs. The guard check runs first, as the
    reference's."""
    validate_shard_guard(cfg.local_grid, cfg.order)
    mesh = as_pic_mesh(mesh)
    sx, sy = mesh.block
    cfg = dataclasses.replace(cfg, ranks=mesh.ranks)

    def step(fields, pos, u, w, alive, slots, pslot, slab_d, slab_valid):
        _check_stack(pos, sx, sy, "pos")
        blocks, *out, _mid_pos, _mid_u, stats = dist_pic_step_local(
            blocks_from_global(fields, sx, sy).unbind(0), pos, u, w, alive, slots, pslot, slab_d, slab_valid, cfg)
        return (tuple(global_from_blocks(torch.stack(blocks)).unbind(0)), *out, stats)

    return step


def make_dist_sort(mesh, cfg: DistConfig):
    """The reference's sort builder: a function of ``(pos, u, w, alive)``,
    shard stacks of ``mesh`` = ``(sx, sy)`` (or of a `PicMesh`'s block on
    this rank), returning every shard's global sort at ``cfg.capacity``
    (`dist_global_sort_device`): ``(pos, u, w, alive, slots, pslot, slab_d,
    slab_valid, overflow)``, the overflow summed over the mesh."""
    mesh = as_pic_mesh(mesh)
    sx, sy = mesh.block
    cfg = dataclasses.replace(cfg, ranks=mesh.ranks)

    def sort(pos, u, w, alive):
        _check_stack(pos, sx, sy, "pos")
        return dist_global_sort_device(pos, u, w, alive, cfg)

    return sort


# -- set-up on the host ---------------------------------------------------------------------


def partition_particles(parts: ParticleState, global_grid: GridSpec, sx: int, sy: int, n_local: int, *,
                        device=None, ranks=None):
    """A global `ParticleState` split into ``[sx, sy, n_local, ...]`` shard
    tensors with local-frame positions, on ``device`` (default: the
    particles'); with a rank grid, only this rank's block of them. Each
    shard keeps its particles in their global order; the split is the
    reference's, in numpy on the host. Fails if a shard would hold more
    than ``n_local``."""
    device = parts.pos.device if device is None else device
    nx_loc = global_grid.shape[0] // sx
    ny_loc = global_grid.shape[1] // sy
    pos = parts.pos.detach().cpu().numpy()
    u = parts.u.detach().cpu().numpy()
    w = parts.w.detach().cpu().numpy()
    alive = parts.alive.detach().cpu().numpy()

    out_pos = np.zeros((sx, sy, n_local, 3), np.float32)
    out_u = np.zeros((sx, sy, n_local, 3), np.float32)
    out_w = np.zeros((sx, sy, n_local), np.float32)
    out_alive = np.zeros((sx, sy, n_local), bool)
    ix = np.clip((pos[:, 0] // nx_loc).astype(int), 0, sx - 1)
    iy = np.clip((pos[:, 1] // ny_loc).astype(int), 0, sy - 1)
    for a in range(sx):
        for b in range(sy):
            m = alive & (ix == a) & (iy == b)
            k = int(m.sum())
            if k > n_local:
                raise ValueError(f"shard ({a},{b}) holds {k} > n_local={n_local} particles")
            local = pos[m].copy()
            local[:, 0] -= a * nx_loc
            local[:, 1] -= b * ny_loc
            out_pos[a, b, :k] = local
            out_u[a, b, :k] = u[m]
            out_w[a, b, :k] = w[m]
            out_alive[a, b, :k] = True
    out = tuple(torch.from_numpy(t) for t in (out_pos, out_u, out_w, out_alive))
    if ranks is not None:
        out = tuple(ranks.block(t) for t in out)
    return tuple(t.to(device) for t in out)


def build_local_bins(pos, alive, local_grid: GridSpec, capacity: int, ranks=None):
    """Each shard's initial bins and slab (the first step's gather consumes
    the slab). Returns ``(slots, pslot, slab_d, slab_valid, overflow)``,
    the overflow summed over the mesh (over every rank's block with a rank
    grid), read on the host."""
    sx, sy = pos.shape[:2]
    outs, overflows = [], []
    for pos_s, alive_s in zip(_shards(pos), _shards(alive)):
        layout, of = build_bins(cell_index(pos_s, local_grid.shape), alive_s, n_cells=local_grid.n_cells,
                                capacity=capacity)
        slab = build_bin_slab(pos_s, layout, grid_shape=local_grid.shape)
        outs.append((layout.slots, layout.particle_slot, slab.d, slab.valid))
        overflows.append(of.to(torch.int64))
    overflow = int(psum_all(_stack(overflows, sx, sy), ranks))
    return (*(_stack(list(c), sx, sy) for c in zip(*outs)), overflow)


def blocks_from_global(fields, sx: int, sy: int, ranks=None) -> torch.Tensor:
    """Six global (NX, NY, NZ) components -> the ``[6, SX, SY, nx, ny, nz]``
    shard blocks; with a rank grid, this rank's ``[6, BX, BY, ...]`` of
    them."""
    f = torch.stack(list(fields))
    _, nxg, nyg, nz = f.shape
    blocks = f.reshape(6, sx, nxg // sx, sy, nyg // sy, nz).permute(0, 1, 3, 2, 4, 5)
    if ranks is not None:
        blocks = ranks.block(blocks, first=1)
    return blocks.contiguous()


def global_from_blocks(blocks: torch.Tensor, ranks=None) -> torch.Tensor:
    """``[6, SX, SY, nx, ny, nz]`` shard blocks -> (6, NX, NY, NZ); with a
    rank grid, every rank's ``[6, BX, BY, ...]`` gathered first."""
    if ranks is not None:
        blocks = ranks.gather(blocks, first=1)
    k, sx, sy, nx, ny, nz = blocks.shape
    return blocks.permute(0, 1, 3, 2, 4, 5).reshape(k, sx * nx, sy * ny, nz)

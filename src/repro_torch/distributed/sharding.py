"""Load-aware planning of the 2-D domain decomposition (the distributed
driver's rebalance). Counterpart of the PIC half of
`repro.distributed.sharding`; the reference's logical-axis rules belong to
the language-model stack and are not here.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.shape_functions import max_guard

__all__ = ["plan_balanced_split", "valid_mesh_splits"]


def valid_mesh_splits(n_devices: int, global_shape, order: int) -> list[tuple[int, int]]:
    """Every (sx, sy) factorization of ``n_devices`` whose local block
    divides the global grid and is at least the deposition guard wide on
    every axis (a halo slab must not wrap into the neighbour's neighbour:
    the check `pic.distributed.validate_shard_guard` makes of the
    configured split). In increasing sx."""
    g = max_guard(order)
    nx, ny, nz = global_shape
    out = []
    for sx in range(1, n_devices + 1):
        if n_devices % sx:
            continue
        sy = n_devices // sx
        if nx % sx or ny % sy:
            continue
        if min(nx // sx, ny // sy, nz) < g:
            continue
        out.append((sx, sy))
    return out


def plan_balanced_split(n_devices: int, global_shape, order: int, pos, alive):
    """The (sx, sy) split with the fewest live particles on its densest
    shard: ``pos`` (N, 3) global positions, ``alive`` (N,), host arrays.
    Ties go to fewer shard columns along x (less x-migration), then to the
    squarer split. Returns ``(sx, sy, peak)``; raises if no split is
    valid."""
    splits = valid_mesh_splits(n_devices, global_shape, order)
    if not splits:
        raise ValueError(f"no valid (sx, sy) split of {n_devices} devices for grid {tuple(global_shape)} at "
                         f"order {order}")
    pos = np.asarray(pos)
    alive = np.asarray(alive)
    x = pos[alive, 0]
    y = pos[alive, 1]
    best = None
    for sx, sy in splits:
        ix = np.clip((x // (global_shape[0] // sx)).astype(int), 0, sx - 1)
        iy = np.clip((y // (global_shape[1] // sy)).astype(int), 0, sy - 1)
        peak = int(np.bincount(ix * sy + iy, minlength=sx * sy).max()) if x.size else 0
        key = (peak, sx, abs(sx - sy))
        if best is None or key < best[0]:
            best = (key, (sx, sy, peak))
    return best[1]

"""Plain PyTorch versions of the gather kernels.

`bin_gather_ref` is the plain version of `csrc/bin_gather.cu`, the
counterpart of `repro.kernels.gather.ref.bin_gather_ref`.
`fused_bin_gather_ref` is the counterpart of
`repro.kernels.gather.ref.fused_bin_gather_ref` on the packed (C, 6, T, T*T)
neighbourhoods; `fused_gather_ref` is the plain version of the CUDA kernel,
which takes the stacked guard-padded grids: it packs the neighbourhoods,
then contracts.
"""

from __future__ import annotations

import torch

from repro_torch.core.gather import EB_STAGGERS, pack_neighborhoods
from repro_torch.core.shape_functions import packed_axis_weights


def bin_gather_ref(wx: torch.Tensor, byz: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """e[c,p] = sum_{m,n} wx[c,p,m] byz[c,p,n] g[c,m,n]: wx (C, cap, M),
    byz (C, cap, N), g (C, M, N) -> (C, cap)."""
    h = torch.einsum("cpn,cmn->cpm", byz, g)
    return torch.sum(wx * h, dim=-1)


def fused_bin_gather_ref(d: torch.Tensor, g: torch.Tensor, *, order: int) -> torch.Tensor:
    """d (C, cap, 3), g (C, 6, T, T*T) packed neighbourhoods -> (C, cap, 6)
    in EB_STAGGERS order."""
    w = packed_axis_weights(d, order)
    outs = []
    for comp, stagger in enumerate(EB_STAGGERS):
        wy = w[(1, stagger[1])]
        wz = w[(2, stagger[2])]
        byz = (wy[..., :, None] * wz[..., None, :]).reshape(d.shape[0], d.shape[1], -1)
        h = torch.einsum("cpn,cmn->cpm", byz, g[:, comp])
        outs.append(torch.sum(w[(0, stagger[0])] * h, dim=-1))
    return torch.stack(outs, dim=-1)


def fused_gather_ref(d: torch.Tensor, padded: torch.Tensor, *, grid_shape, order: int, guard: int) -> torch.Tensor:
    """d (C, cap, 3), padded (6, nx+2g, ny+2g, nz+2g) -> (C, cap, 6), or the
    same with a leading member axis on all three (the members' cells
    folded into one contraction)."""
    g = pack_neighborhoods(padded, grid_shape=grid_shape, order=order, guard=guard)
    out = fused_bin_gather_ref(d.reshape(-1, *d.shape[-2:]), g.reshape(-1, *g.shape[-3:]), order=order)
    return out.reshape(*d.shape[:-1], 6)

"""Launchers of the gather CUDA kernels.

Counterpart of `repro.kernels.gather.kernel`:

  fused_gather_cuda  <- fused_gather_pallas (`csrc/fused_gather.cu`); it
                        reads the six guard-padded field grids directly
                        instead of the packed (C, 6, T, T*T) neighbourhoods
                        the Pallas kernel takes
  bin_gather_cuda    <- bin_gather_pallas (`csrc/bin_gather.cu`)

The checks, allocation and launch counting live in `ops.py`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import check, load_library


def fused_gather_cuda(d: torch.Tensor, padded: torch.Tensor, out: torch.Tensor, *, grid_shape,
                      order: int, guard: int, geometry) -> None:
    """d (C, cap, 3), padded (6, nx+2g, ny+2g, nz+2g) -> out (C, cap, 6),
    or the same with a leading axis of ``geometry.members`` members,
    launched with ``geometry`` (`ops.gather_geometry`; the kernel refuses
    another)."""
    nx, ny, nz = grid_shape
    rc = load_library().mpic_fused_gather(
        d.data_ptr(), padded.data_ptr(), out.data_ptr(), geometry.members, nx, ny, nz, d.shape[-2], order, guard,
        geometry.run, geometry.threads, geometry.smem,
        d.device.index, torch.cuda.current_stream(d.device).cuda_stream,
    )
    check(rc, "fused_gather_cuda")


def bin_gather_cuda(wx: torch.Tensor, byz: torch.Tensor, g: torch.Tensor, out: torch.Tensor, *, geometry) -> None:
    """wx (C, cap, M), byz (C, cap, N), g (C, M, N) -> out (C, cap),
    launched with ``geometry`` (`ops.bin_gather_geometry`; the kernel
    refuses another)."""
    n_cells, cap, m = wx.shape
    rc = load_library().mpic_bin_gather(
        wx.data_ptr(), byz.data_ptr(), g.data_ptr(), out.data_ptr(), n_cells, cap, m, byz.shape[2],
        geometry.group, geometry.stages, geometry.threads, geometry.smem, geometry.blocks,
        wx.device.index, torch.cuda.current_stream(wx.device).cuda_stream,
    )
    check(rc, "bin_gather_cuda")

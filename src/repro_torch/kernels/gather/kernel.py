"""Launcher of the fused gather CUDA kernel (`csrc/fused_gather.cu`).

Counterpart of `repro.kernels.gather.kernel`: ``fused_gather_cuda`` <-
``fused_gather_pallas``. It reads the six guard-padded field grids directly
instead of the packed (C, 6, T, T*T) neighbourhoods the Pallas kernel takes.
The checks, allocation and launch counting live in `ops.py`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import check, load_library


def fused_gather_cuda(d: torch.Tensor, padded: torch.Tensor, out: torch.Tensor, *, grid_shape,
                      order: int, guard: int) -> None:
    """d (C, cap, 3), padded (6, nx+2g, ny+2g, nz+2g) -> out (C, cap, 6)."""
    nx, ny, nz = grid_shape
    rc = load_library().mpic_fused_gather(
        d.data_ptr(), padded.data_ptr(), out.data_ptr(), nx, ny, nz, d.shape[1], order, guard,
        d.device.index, torch.cuda.current_stream(d.device).cuda_stream,
    )
    check(rc, "fused_gather_cuda")

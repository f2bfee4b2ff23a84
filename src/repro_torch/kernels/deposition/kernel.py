"""Launchers of the fused deposition CUDA kernels (`csrc/fused_deposition.cu`).

Counterpart of `repro.kernels.deposition.kernel` (the Pallas megakernels):

  fused_deposition_cuda          <- fused_deposition_pallas
  fused_deposition_reduced_cuda  <- fused_deposition_reduced_pallas

Each takes checked, contiguous float32 CUDA tensors and a preallocated
output, launches on the current stream and raises if the launch failed. The
checks, allocation and launch counting live in `ops.py`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import check, load_library


def fused_deposition_cuda(d: torch.Tensor, val: torch.Tensor, out: torch.Tensor, *, order: int) -> None:
    """d, val (C, cap, 3) -> out (C, 3, T, T*T)."""
    n_cells, cap, _ = d.shape
    rc = load_library().mpic_fused_deposit(
        d.data_ptr(), val.data_ptr(), out.data_ptr(), n_cells, cap, order,
        d.device.index, torch.cuda.current_stream(d.device).cuda_stream,
    )
    check(rc, "fused_deposition_cuda")


def fused_deposition_reduced_cuda(d: torch.Tensor, val: torch.Tensor, out: torch.Tensor, *,
                                  order: int, nz: int, guard: int) -> None:
    """d, val (nx*ny*nz, cap, 3) -> out (nx*ny, 3, nz+2g, T, T)."""
    n_cells, cap, _ = d.shape
    rc = load_library().mpic_fused_deposit_reduced(
        d.data_ptr(), val.data_ptr(), out.data_ptr(), n_cells // nz, nz, cap, order, guard,
        d.device.index, torch.cuda.current_stream(d.device).cuda_stream,
    )
    check(rc, "fused_deposition_reduced_cuda")

"""Launchers of the fused deposition CUDA kernels (`csrc/fused_deposition.cu`).

Counterpart of `repro.kernels.deposition.kernel` (the Pallas kernels):

  fused_deposition_cuda          <- fused_deposition_pallas
  fused_deposition_reduced_cuda  <- fused_deposition_reduced_pallas
  bin_outer_product_cuda         <- bin_outer_product_pallas
                                    (`csrc/bin_outer_product.cu`)

Each takes checked, contiguous CUDA tensors and a preallocated
output, launches on the current stream and raises if the launch failed. The
checks, allocation and launch counting live in `ops.py`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import check, load_library


def fused_deposition_cuda(d: torch.Tensor, val: torch.Tensor, out: torch.Tensor, *, order: int, geometry) -> None:
    """d, val (C, cap, 3) -> out (C, 3, T, T*T), launched with ``geometry``
    (`ops.packed_geometry`; the kernel refuses another)."""
    n_cells, cap, _ = d.shape
    rc = load_library().mpic_fused_deposit(
        d.data_ptr(), val.data_ptr(), out.data_ptr(), n_cells, cap, order,
        geometry.cells_per_lane, geometry.lanes_per_block, geometry.threads, geometry.smem,
        d.device.index, torch.cuda.current_stream(d.device).cuda_stream,
    )
    check(rc, "fused_deposition_cuda")


def fused_deposition_reduced_cuda(d: torch.Tensor, val: torch.Tensor, out: torch.Tensor, *,
                                  order: int, nz: int, guard: int, geometry) -> None:
    """d, val (nx*ny*nz, cap, 3) -> out (nx*ny, 3, nz+2g, T, T), launched
    with ``geometry`` (`ops.reduced_geometry`; the kernel refuses another)."""
    n_cells, cap, _ = d.shape
    rc = load_library().mpic_fused_deposit_reduced(
        d.data_ptr(), val.data_ptr(), out.data_ptr(), n_cells // nz, nz, cap, order, guard,
        geometry.cols_per_block, geometry.threads, geometry.smem,
        d.device.index, torch.cuda.current_stream(d.device).cuda_stream,
    )
    check(rc, "fused_deposition_reduced_cuda")


def bin_outer_product_cuda(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *, geometry) -> None:
    """a (C, cap, M), b (C, cap, N), both float32 or both bfloat16 -> out
    (C, M, N) float32, launched with ``geometry``
    (`ops.bin_outer_product_geometry`; the kernel refuses another)."""
    n_cells, cap, m = a.shape
    rc = load_library().mpic_bin_outer_product(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), n_cells, cap, m, b.shape[2],
        geometry.group, geometry.stages, geometry.threads, geometry.smem, geometry.blocks,
        int(a.dtype == torch.bfloat16), a.device.index, torch.cuda.current_stream(a.device).cuda_stream,
    )
    check(rc, "bin_outer_product_cuda")

"""Launcher of the segment accumulation CUDA kernel
(`csrc/segment_accumulate.cu`).

Counterpart of `repro.kernels.scatter_matrix.kernel`:
``segment_accumulate_cuda`` <- ``segment_accumulate_pallas``. The checks,
allocation and launch counting live in `ops.py`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import check, load_library


def segment_accumulate_cuda(w: torch.Tensor, u: torch.Tensor, out: torch.Tensor) -> None:
    """w (V, cap), u (V, cap, D), both float32 or both bfloat16 -> out
    (V, D) in their type."""
    n_bins, cap = w.shape
    rc = load_library().mpic_segment_accumulate(
        w.data_ptr(), u.data_ptr(), out.data_ptr(), n_bins, cap, u.shape[2], int(u.dtype == torch.bfloat16),
        u.device.index, torch.cuda.current_stream(u.device).cuda_stream,
    )
    check(rc, "segment_accumulate_cuda")

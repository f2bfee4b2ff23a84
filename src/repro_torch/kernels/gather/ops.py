"""Wrapper of the fused gather kernel: the ``cuda`` rung of the
``gather_fused`` op. Counterpart of `repro.kernels.gather.ops`.

It checks its arguments and raises on what the kernel does not take. A
tensor on the CPU runs the plain PyTorch version (`ref.py`); a CUDA tensor
launches the kernel, and nothing else. ``LAUNCHES`` counts kernel launches,
and only those.
"""

from __future__ import annotations

import torch

from repro_torch.core.shape_functions import max_guard
from repro_torch.kernels.gather import kernel
from repro_torch.kernels.gather.ref import fused_gather_ref

LAUNCHES = {"fused_bin_gather": 0}


def fused_bin_gather(d: torch.Tensor, padded: torch.Tensor, *, grid_shape, order: int, guard: int) -> torch.Tensor:
    """Fused Ex..Bz gather: d (C, cap, 3) slab offsets and the six stacked
    guard-padded grids (6, nx+2g, ny+2g, nz+2g) -> (C, cap, 6) float32
    per-bin values in EB_STAGGERS order."""
    if order not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2 or 3, got {order}")
    nx, ny, nz = (int(s) for s in grid_shape)
    if d.dim() != 3 or d.shape[2] != 3 or d.shape[1] < 1 or d.shape[0] != nx * ny * nz:
        raise ValueError(f"d must be ({nx * ny * nz}, cap, 3) for grid {(nx, ny, nz)}, got {tuple(d.shape)}")
    if guard < max_guard(order):
        raise ValueError(f"guard {guard} is below max_guard({order}) = {max_guard(order)}")
    want = (6, nx + 2 * guard, ny + 2 * guard, nz + 2 * guard)
    if tuple(padded.shape) != want:
        raise ValueError(f"padded must be {want}, got {tuple(padded.shape)}")
    if d.dtype != torch.float32 or padded.dtype != torch.float32:
        raise TypeError(f"d and padded must be float32, got {d.dtype} and {padded.dtype}")
    if d.device != padded.device:
        raise ValueError(f"d and padded on different devices: {d.device}, {padded.device}")
    if d.device.type == "cpu":
        return fused_gather_ref(d, padded, grid_shape=(nx, ny, nz), order=order, guard=guard)
    if d.device.type != "cuda":
        raise ValueError(f"unsupported device {d.device}")
    if not (d.is_contiguous() and padded.is_contiguous()):
        raise ValueError("d and padded must be contiguous")
    out = torch.empty((d.shape[0], d.shape[1], 6), dtype=torch.float32, device=d.device)
    kernel.fused_gather_cuda(d, padded, out, grid_shape=(nx, ny, nz), order=order, guard=guard)
    LAUNCHES["fused_bin_gather"] += 1
    return out

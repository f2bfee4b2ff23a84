"""Wrapper of the segment accumulation kernel, the ``cuda`` rung of the
``segment_accumulate`` op (stage 2 of `core.matrix_scatter.
matrix_scatter_add`). Counterpart of `repro.kernels.scatter_matrix.ops`.

It checks its arguments and raises on what the kernel does not take. A
tensor on the CPU runs the plain PyTorch version (`ref.py`); a CUDA tensor
launches the kernel, and nothing else. ``LAUNCHES`` counts kernel launches,
and only those.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.scatter_matrix import kernel
from repro_torch.kernels.scatter_matrix.ref import segment_accumulate_ref

LAUNCHES = {"segment_accumulate": 0}

#: the bin's weights the kernel stages in the default 48 KB of shared memory
MAX_CAPACITY = 12_288
#: feature tiles of 1024 columns the grid's second axis can hold
MAX_DIM = 65_535 * 1024


def segment_accumulate(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """out[v, :] = sum_c w[v, c] * u[v, c, :]: w (V, cap), u (V, cap, D),
    both float32 or both bfloat16 -> (V, D) in u's type, accumulated in
    float32. On the CPU any float type runs the plain version."""
    if w.dim() != 2 or u.dim() != 3 or u.shape[:2] != w.shape or min(u.shape) < 1:
        raise ValueError(f"w must be (V, cap) and u (V, cap, D), got {tuple(w.shape)} and {tuple(u.shape)}")
    if w.dtype != u.dtype or not u.dtype.is_floating_point:
        raise TypeError(f"w and u must share one floating type, got {w.dtype} and {u.dtype}")
    if w.device != u.device:
        raise ValueError(f"w and u on different devices: {w.device}, {u.device}")
    if u.device.type == "cpu":
        return segment_accumulate_ref(w, u)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got {u.dtype}")
    if not (w.is_contiguous() and u.is_contiguous()):
        raise ValueError("w and u must be contiguous")
    if u.shape[1] > MAX_CAPACITY or u.shape[2] > MAX_DIM:
        raise ValueError(f"capacity {u.shape[1]} or width {u.shape[2]} over the kernel's {MAX_CAPACITY}, {MAX_DIM}")
    out = torch.empty((u.shape[0], u.shape[2]), dtype=u.dtype, device=u.device)
    kernel.segment_accumulate_cuda(w, u, out)
    LAUNCHES["segment_accumulate"] += 1
    return out

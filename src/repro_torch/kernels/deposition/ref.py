"""Plain PyTorch versions of the deposition kernels.

The same math as `csrc/fused_deposition.cu` and `csrc/bin_outer_product.cu`
in tensor ops; the counterpart of `repro.kernels.deposition.ref`. A CPU
tensor given to a kernel wrapper runs these; the tests and `chip_smoke.py`
hold the kernels to them.
"""

from __future__ import annotations

import torch

from repro_torch.core.shape_functions import shape_weights_window, unified_support


def bin_outer_product_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[c] = A_c^T B_c: a (C, cap, M), b (C, cap, N) -> (C, M, N)
    float32 (bfloat16 operands are widened first, as the kernel does)."""
    return torch.einsum("cpm,cpn->cmn", a.float(), b.float())


def fused_bin_deposit_ref(d: torch.Tensor, val: torch.Tensor, *, order: int) -> torch.Tensor:
    """d, val: (C, cap, 3) -> (C, 3, T, T*T) packed rhocell tiles on the
    unified tap window of ``order`` (component k staggered on axis k)."""
    t, base = unified_support(order)
    c, cap, _ = d.shape
    packed = []
    for comp in range(3):
        wx = shape_weights_window(d[..., 0], order, comp == 0, n_taps=t, base=base)
        wy = shape_weights_window(d[..., 1], order, comp == 1, n_taps=t, base=base)
        wz = shape_weights_window(d[..., 2], order, comp == 2, n_taps=t, base=base)
        a = wx * val[..., comp][..., None]
        byz = (wy[..., :, None] * wz[..., None, :]).reshape(c, cap, t * t)
        packed.append(torch.einsum("cpm,cpn->cmn", a, byz))
    return torch.stack(packed, dim=1)


def fused_bin_deposit_reduced_ref(d: torch.Tensor, val: torch.Tensor, *, order: int, grid_shape,
                                  guard: int) -> torch.Tensor:
    """The packed tiles followed by the rhocell z pass, per (x, y) column:
    (nx*ny*nz, cap, 3) -> (nx*ny, 3, nz+2g, T, T)."""
    packed = fused_bin_deposit_ref(d, val, order=order)
    return column_z_pass(packed, order=order, grid_shape=grid_shape, guard=guard)


def column_z_pass(packed: torch.Tensor, *, order: int, grid_shape, guard: int) -> torch.Tensor:
    """The rhocell z pass of packed tiles (nx*ny*nz, 3, T, T*T) -> (nx*ny, 3,
    nz+2g, T, T), or of several grids' cells one after another to their
    columns one after another: each row adds its taps in ascending tap
    order, starting from zero."""
    nz = grid_shape[2]
    g = guard
    t, base = unified_support(order)
    rho = packed.reshape(-1, nz, 3, t, t, t)
    acc = packed.new_zeros((rho.shape[0], 3, nz + 2 * g, t, t))
    for c in range(t):
        acc[:, :, g + base + c : g + base + c + nz] += torch.movedim(rho[..., c], 1, 2)
    return acc

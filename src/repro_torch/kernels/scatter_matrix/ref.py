"""Plain PyTorch version of the segment accumulation kernel; the
counterpart of `repro.kernels.scatter_matrix.ref`.

It sums over the slots in ascending order, each product and each add
rounded on its own in float32, as `csrc/segment_accumulate.cu` does: the
two agree to the bit, also after the final rounding to bfloat16.
"""

from __future__ import annotations

import torch


def segment_accumulate_ref(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """out[v] = sum_c w[v, c] * u[v, c, :]: w (V, cap), u (V, cap, D) ->
    (V, D) in u's type, accumulated in float32."""
    acc = torch.zeros((u.shape[0], u.shape[2]), dtype=torch.float32, device=u.device)
    for c in range(u.shape[1]):
        acc = acc + w[:, c, None].float() * u[:, c].float()
    return acc.to(u.dtype)

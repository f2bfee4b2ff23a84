"""Generalized Matrix-PIC scatter-add: sort -> bin -> dense accumulate.

Counterpart of `repro.core.matrix_scatter`. The paper's Appendix B argues
the co-design applies to any "sparse sources -> dense target" accumulation;
in a language model that is the embedding-table gradient and the MoE
combine. The three stages are the deposition's:

  stage 1 (sort):     a stable counting sort of the items into a
                      (n_bins, capacity) layout with gaps;
  stage 2 (matrix):   per bin, out[v] = sum_c w[v, c] * U[v, c, :], through
                      the dispatcher op ``segment_accumulate`` (``cuda``:
                      the `segment_accumulate` kernel; ``torch``: its plain
                      version);
  stage 3 (overflow): the items beyond a bin's capacity are added by a plain
                      scatter-add (exact).

`matrix_scatter_add` is exact for any input; the capacity only moves items
between the dense and the overflow stage. Integer updates take the exact
integer contraction in stage 2 (the kernel accumulates in float32).
"""

from __future__ import annotations

import torch


def bin_items(indices: torch.Tensor, updates: torch.Tensor, *, n_bins: int, capacity: int, weights=None):
    """Stage 1: the items' weights and updates in a gapped bin layout.

    Returns ``(binned_w (n_bins, capacity), binned_u (n_bins, capacity, D),
    of_idx (T,), of_upd (T, D))``: gaps hold 0; ``of_idx``/``of_upd`` are
    the overflow items' bins and weighted updates, bin ``n_bins`` and 0 for
    every other item."""
    t, dim = indices.shape[0], updates.shape[1]
    dev = updates.device
    alive = indices >= 0
    key = torch.where(alive, indices.long(), n_bins)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    first = torch.searchsorted(sorted_key, sorted_key, side="left")
    rank = torch.arange(t, device=dev) - first
    live = sorted_key < n_bins
    in_dense = live & (rank < capacity)

    # items outside the dense set go to one dump slot, dropped afterwards
    dump = n_bins * capacity
    dst = torch.where(in_dense, sorted_key * capacity + rank, dump)
    w = torch.ones((t,), dtype=updates.dtype, device=dev) if weights is None else weights.to(updates.dtype)
    binned_u = torch.zeros((dump + 1, dim), dtype=updates.dtype, device=dev)
    binned_u[dst] = updates[order]
    binned_w = torch.zeros((dump + 1,), dtype=updates.dtype, device=dev)
    binned_w[dst] = w[order]

    overflow = live & (rank >= capacity)
    of_idx = torch.where(overflow, sorted_key, n_bins)
    zero = torch.zeros((), dtype=updates.dtype, device=dev)
    of_upd = torch.where(overflow[:, None], w[order][:, None] * updates[order], zero)
    return binned_w[:-1].reshape(n_bins, capacity), binned_u[:-1].reshape(n_bins, capacity, dim), of_idx, of_upd


def matrix_scatter_add(indices, updates, *, n_bins: int, capacity: int, weights=None, backend: str = "auto"):
    """out[v] = sum_{i: indices[i] == v} weights[i] * updates[i].

    indices: (T,) bin ids in [0, n_bins) (negative: dropped); updates:
    (T, D); weights: optional (T,). Returns (n_bins, D) in the updates'
    type."""
    from repro_torch.kernels import dispatch

    binned_w, binned_u, of_idx, of_upd = bin_items(indices, updates, n_bins=n_bins, capacity=capacity,
                                                   weights=weights)
    if not updates.dtype.is_floating_point:
        out = torch.sum(binned_w[..., None] * binned_u, dim=1, dtype=updates.dtype)
    elif dispatch.resolve("segment_accumulate", backend, device=updates.device, capacity=capacity, n_bins=n_bins,
                          dtype=updates.dtype, width=updates.shape[1]) == "cuda":
        from repro_torch.kernels.scatter_matrix.ops import segment_accumulate

        out = segment_accumulate(binned_w, binned_u)
    else:
        from repro_torch.kernels.scatter_matrix.ref import segment_accumulate_ref

        out = segment_accumulate_ref(binned_w, binned_u)
    out_ext = torch.cat([out, torch.zeros((1, out.shape[1]), dtype=out.dtype, device=out.device)])
    out_ext.index_add_(0, of_idx, of_upd)
    return out_ext[:-1]


def scatter_add_ref(indices, updates, *, n_bins: int, weights=None):
    """Plain scatter-add oracle."""
    alive = indices >= 0
    dtype, dev = updates.dtype, updates.device
    w = torch.ones(indices.shape, dtype=dtype, device=dev) if weights is None else weights.to(dtype)
    upd = torch.where(alive[:, None], w[:, None] * updates, torch.zeros((), dtype=dtype, device=dev))
    idx = torch.where(alive, indices.long(), n_bins)
    out = torch.zeros((n_bins + 1, updates.shape[1]), dtype=dtype, device=dev)
    out.index_add_(0, idx, upd)
    return out[:-1]

"""Quantized payloads of the distributed collectives. Counterpart of
`repro.distributed.compression`: its two consumers share the fixed-point
core here (`quantize_fixed`, `dequantize_fixed`).

1. **Error-feedback int8 gradient all-reduce** over a data axis whose
   shards are stacked as the leading dim of every leaf, ``[n, ...]`` (one
   device holds them all; a ``psum`` is a sum over that dim):

     1. g' = g + residual                  (error feedback)
     2. scale = max(|g'|) over every shard / 127
     3. q = round(g'/scale) in int8
     4. G = sum(q as int32) * scale / n    (integer all-reduce)
     5. residual' = g' - dequant(q)        (compression error carried forward)

   `compressed_psum_grads` keeps the reference's arithmetic in its order,
   bit for bit; `exact_pmean_grads` is the exact mean it is compared with.
   The reference's residuals leave its ``shard_map`` as one array that
   claims to be replicated while each device keeps its own; here they are
   held openly per shard.

   Over ranks (``ranks``, a `distributed.ranks.AxisRanks` on the data
   axis) a rank's leaves are its block ``[n_local, ...]`` of the ``n``
   shards, and both reductions stay bit-equal to the stacked call: the max
   over every shard is the max of the ranks' gathered maxima (a max is
   exact in any order), the int32 sum an ``all_reduce`` of the block's
   partial sums (integers add exactly in any order: the reference's
   ``psum`` of int32), and the exact mean adds the gathered shards one
   after another, as one process does. ``n`` in ``scale / n`` is the
   global shard count.

2. **Compressed migration payloads** of the PIC driver. Positions are
   shard-relative after the migration's coordinate shift, so they quantize
   to uint16 fixed point over the local block's extent plus a band of
   `POS_MARGIN` cells on each side (a particle leaving along x may still be
   out of range along y, and clipping that coordinate into range would
   cancel its next migration). Momenta cross as bfloat16; weights stay
   float32, so the total charge is conserved exactly. The error of a
   position component is at most ``(extent + 2 * POS_MARGIN) / 2**16``
   cells. Bytes a buffered row (pos + u + w): 28 exact (3 x f32, 3 x f32,
   f32), 16 compressed (3 x u16, 3 x bf16, f32).
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_map

__all__ = [
    "MIG_ROW_BYTES_COMPRESSED",
    "MIG_ROW_BYTES_EXACT",
    "POS_MARGIN",
    "compressed_psum_grads",
    "dequantize_fixed",
    "exact_pmean_grads",
    "pack_momenta",
    "pack_positions",
    "quantize_fixed",
    "unpack_momenta",
    "unpack_positions",
    "zeros_like_residual",
]

# CFL bounds a step's motion below one cell, so any coordinate of a
# migrating particle lies in [-POS_MARGIN, extent + POS_MARGIN)
POS_MARGIN = 2.0

MIG_ROW_BYTES_EXACT = 3 * 4 + 3 * 4 + 4
MIG_ROW_BYTES_COMPRESSED = 3 * 2 + 3 * 2 + 4


def quantize_fixed(x, scale, *, qmin: int, qmax: int, dtype, zero=0.0):
    """``round((x - zero) / scale)`` clipped into [qmin, qmax], as ``dtype``
    (round half to even, as the reference). ``scale`` and ``zero`` are
    scalars or tensors that broadcast against ``x``."""
    q = torch.round((x - zero) / scale)
    return torch.clamp(q, qmin, qmax).to(dtype)


def dequantize_fixed(q, scale, *, zero=0.0, dtype=torch.float32):
    return q.to(dtype) * scale + zero


# ---------------------------------------------------------------------------
# error-feedback int8 gradient all-reduce over a stacked data axis
# ---------------------------------------------------------------------------


def zeros_like_residual(grads):
    """float32 zeros of the (stacked) gradients' shapes."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def _compress_one(g, r, ranks=None):
    # the divisors are 0-d tensors on g's device: ATen divides a CUDA tensor
    # by a Python scalar as a multiply by its rounded reciprocal
    div = lambda v: torch.full((), float(v), dtype=torch.float32, device=g.device)  # noqa: E731
    g32 = g.float() + r
    amax = g32.abs().amax()
    if ranks is not None:
        amax = ranks.values(amax).amax()
    scale = torch.clamp_min(amax, 1e-12) / div(127.0)
    q = quantize_fixed(g32, scale, qmin=-127, qmax=127, dtype=torch.int8)
    new_r = g32 - dequantize_fixed(q, scale)
    isum = q.to(torch.int32).sum(0)
    if ranks is not None:
        ranks.sum_exact(isum)
    summed = isum.float() * scale / div(g.shape[0] if ranks is None else ranks.n)
    return summed.to(g.dtype), new_r


def compressed_psum_grads(grads, residuals, ranks=None):
    """Gradients ``[n, ...]`` (one row a data shard) and float32 residuals
    of the same shapes -> (the compressed mean over the shards, without the
    shard dim, in the gradients' dtype; the new residuals ``[n, ...]``).
    Over ``ranks`` both are this rank's block ``[n_local, ...]``; the mean,
    over every rank's shards, is the same on every rank."""
    pairs = tree_map(lambda g, r: _compress_one(g, r, ranks), grads, residuals)
    return tree_map(lambda _, p: p[0], grads, pairs), tree_map(lambda _, p: p[1], grads, pairs)


def _mean_one(g):
    # one shard after another in g's dtype, as the reference's psum adds
    # (a library sum's order depends on the shape and the device)
    acc = g[0].clone()
    for i in range(1, g.shape[0]):
        acc += g[i]
    return acc / torch.full((), float(g.shape[0]), dtype=g.dtype, device=g.device)


def exact_pmean_grads(grads, ranks=None):
    """The mean of stacked gradients ``[n, ...]`` over their shard dim;
    over ``ranks`` of this rank's block ``[n_local, ...]`` and every other
    rank's, gathered and added in the stacked order."""
    return tree_map(lambda g: _mean_one(g if ranks is None else ranks.gather(g)), grads)


# ---------------------------------------------------------------------------
# migration payload packing (pic.distributed.migrate_axis)
# ---------------------------------------------------------------------------


def _pos_scales(local_shape, dtype, device):
    """Per-axis (scale, zero) mapping [-POS_MARGIN, extent + POS_MARGIN)
    onto the uint16 range."""
    # fill kernels, not a copy from the host: the exchange runs inside a
    # captured graph
    ext = torch.stack([torch.full((), float(n), dtype=dtype, device=device) for n in local_shape])
    scale = (ext + 2.0 * POS_MARGIN) / 65536.0
    zero = torch.full_like(ext, -POS_MARGIN)
    return scale, zero


def pack_positions(pos, local_shape):
    """(..., 3) shard-relative positions -> uint16 fixed point. A value
    dequantizes below ``extent + POS_MARGIN``, so an out-of-range
    coordinate stays out of range and migrates again."""
    scale, zero = _pos_scales(local_shape, pos.dtype, pos.device)
    return quantize_fixed(pos, scale, zero=zero, qmin=0, qmax=65535, dtype=torch.uint16)


def unpack_positions(q, local_shape, dtype=torch.float32):
    scale, zero = _pos_scales(local_shape, dtype, q.device)
    return dequantize_fixed(q, scale, zero=zero, dtype=dtype)


def pack_momenta(u):
    return u.to(torch.bfloat16)


def unpack_momenta(q, dtype=torch.float32):
    return q.to(dtype)

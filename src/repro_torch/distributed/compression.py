"""Compressed migration payloads of the distributed driver. Counterpart of
the PIC half of `repro.distributed.compression`.

Positions are shard-relative after the migration's coordinate shift, so
they quantize to uint16 fixed point over the local block's extent plus a
band of `POS_MARGIN` cells on each side (a particle leaving along x may
still be out of range along y, and clipping that coordinate into range
would cancel its next migration). Momenta cross as bfloat16; weights stay
float32, so the total charge is conserved exactly. The error of a position
component is at most ``(extent + 2 * POS_MARGIN) / 2**16`` cells.

Bytes a buffered row (pos + u + w): 28 exact (3 x f32, 3 x f32, f32), 16
compressed (3 x u16, 3 x bf16, f32).

The reference's other half, the error-feedback int8 gradient all-reduce,
serves the language-model stack and is not here.
"""

from __future__ import annotations

import torch

__all__ = [
    "MIG_ROW_BYTES_COMPRESSED",
    "MIG_ROW_BYTES_EXACT",
    "POS_MARGIN",
    "dequantize_fixed",
    "pack_momenta",
    "pack_positions",
    "quantize_fixed",
    "unpack_momenta",
    "unpack_positions",
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

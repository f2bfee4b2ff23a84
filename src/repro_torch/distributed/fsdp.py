"""The ``fsdp`` rule over the data ranks (ZeRO-3): each data rank holds its
slice of every parameter whose logical axes name ``fsdp``, and of both
AdamW moments, and gathers the whole leaf only where a layer reads it. The
port's counterpart of what GSPMD does for `rules_for`'s ``"fsdp": batch``
(`repro.distributed.sharding`): every attention, MLP, MoE, Mamba and
xLSTM matrix names an ``fsdp`` dimension.

An `FSDP` carries the data axis's ranks (an `AxisRanks` over the data
group of a `MeshRanks` layout), the rule table and the model's whole
parameter shapes. Rank ``d`` of ``D`` holds the contiguous block
`block_range` of each such leaf's ``fsdp`` dimension (after the model
axis's cut, `sharding.ModelBlocks`). `FSDP.take` is the gather, an autograd
boundary a leaf:

* forward: every data rank's slice gathered into the whole leaf
  (`AxisRanks.gather_dim`, uneven slices padded to the widest);
* backward: the whole leaf's cotangent summed over the data ranks in rank
  order, of which the rank keeps its slice (`AxisRanks.reduce_scatter`).

The transformer takes each period's leaves inside the period's remat
region, so no period's gathered weights outlive it and its recompute
gathers them again; the tail's and the encoder's layers are taken where
they run. The gather knows no layer kind.

A train step (`train.step`) binds a sink to each cut leaf for the span of
its backward (`FSDP.sinks`, `FSDP.bound`): the backward then adds its
slice of the sum into the sink rather than hand it to autograd, so that
the gradient keeps the step's accumulation dtype (a sink's ``scale`` set:
each rank's contribution is ``g.float() / scale``, the one-process step's
``g.float() / K``; unset: ``g`` in the leaf's dtype), and a stacked leaf's
periods land in their rows of it. A leaf with no sink gets its slice as
its gradient. Each gather
and reduce-scatter is counted in ``counts`` (``param_gather``,
``reduce_scatter``), its bytes in ``sent`` and its span in the step's
``marks`` (`tensor_parallel.StepCollectives`).
"""

from __future__ import annotations

import contextlib
import functools
import operator

import torch

from repro_torch.distributed.sharding import _rebuild, _zip_leaves, data_dim
from repro_torch.distributed.tensor_parallel import StepCollectives

__all__ = ["FSDP"]


class _Sink:
    """A cut leaf's gradient, summed into as the backward reaches it: zeros
    of the leaf's shape on the first add, in float32 where ``scale`` is
    set (each contribution then divided by it), else in the leaf's
    dtype."""

    def __init__(self, leaf: torch.Tensor, scale: int | None):
        self.shape, self.device, self.scale = tuple(leaf.shape), leaf.device, scale
        self.dtype = leaf.dtype if scale is None else torch.float32
        self.tensor: torch.Tensor | None = None

    def add_(self, i, block: torch.Tensor) -> None:
        if self.tensor is None:
            self.tensor = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        (self.tensor if i is None else self.tensor[i]).add_(block)

    def value(self) -> torch.Tensor:
        """The sum, or zeros where no backward reached the leaf."""
        if self.tensor is None:
            self.tensor = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return self.tensor


class FSDP(StepCollectives):
    """The data axis over ranks (``ranks``, an `AxisRanks` of the data
    group) under the rule table ``table``; ``axes`` and ``whole``: the
    parameters' logical axes and whole shapes (tensors, on ``meta`` as
    well), the trees `FSDP.take` reads by path."""

    def __init__(self, ranks, table: dict, axes, whole):
        super().__init__(ranks)
        self.table = dict(table)
        self.axes, self.whole = axes, whole
        self._bound: dict[int, _Sink] = {}

    def __repr__(self) -> str:
        return f"FSDP(rank={self.rank}, world={self.world})"

    def sinks(self, leaves, cut, scale: int | None) -> list:
        """A sink for each of ``leaves`` flagged in ``cut``, summing its
        slice's gradient, each contribution divided by ``scale`` in float32
        (None: in the leaf's dtype, undivided); None for the others."""
        return [_Sink(leaf, scale) if c else None for leaf, c in zip(leaves, cut, strict=True)]

    @contextlib.contextmanager
    def bound(self, leaves, sinks):
        """``sinks`` (`FSDP.sinks`') bound to ``leaves`` (by identity) for
        the backwards of the gathers `take` makes meanwhile."""
        self._bound = {id(leaf): s for leaf, s in zip(leaves, sinks, strict=True) if s is not None}
        try:
            yield
        finally:
            self._bound = {}

    def take(self, tree, path: tuple, i: int | None = None):
        """The leaves of ``tree`` (the parameters' subtree at ``path``), at
        period ``i`` of their stack axis where ``i`` is given, each leaf
        that the table cuts over the data ranks gathered whole."""
        axes = functools.reduce(operator.getitem, path, self.axes)
        whole = functools.reduce(operator.getitem, path, self.whole)
        out = []
        for (leaf, ax), (full, _) in zip(_zip_leaves(tree, axes), _zip_leaves(whole, axes), strict=True):
            part, shape = (leaf, full.shape) if i is None else (leaf[i], full.shape[1:])
            dim = data_dim(ax if i is None else ax[1:], self.table)
            if dim is None:
                out.append(part)
            else:
                out.append(_GatherParam.apply(part, self, dim, shape[dim], self._bound.get(id(leaf)), i))
        return _rebuild(tree, axes, iter(out))


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, fs, dim, n, sink, i):
        ctx.fs, ctx.dim, ctx.n, ctx.sink, ctx.i, ctx.dtype = fs, dim, n, sink, i, part.dtype
        start = fs._mark()
        whole = fs.ranks.gather_dim(part, dim, n)
        fs._charge(start, "param_gather", part.numel() * part.element_size())
        return whole

    @staticmethod
    def backward(ctx, g):
        fs = ctx.fs
        c = g if ctx.sink is None or ctx.sink.scale is None else g.to(torch.float32) / ctx.sink.scale
        start = fs._mark()
        block = fs.ranks.reduce_scatter(c, ctx.dim, ctx.n)
        fs._charge(start, "reduce_scatter", c.numel() * c.element_size())
        if ctx.sink is not None:
            ctx.sink.add_(ctx.i, block)
            return None, None, None, None, None, None
        return block.to(ctx.dtype), None, None, None, None, None

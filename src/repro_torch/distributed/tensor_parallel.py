"""The LM stack's model axis over ranks: tensor and vocabulary parallelism
for attention and dense-MLP layers, and expert parallelism (or tensor
parallelism inside each expert) for MoE layers, the port's counterpart of
what GSPMD inserts from the reference's rules
(`distributed.sharding.rules_for`: ``heads``, ``kv_heads``, ``mlp``,
``vocab`` and ``experts`` or ``expert_mlp`` map to ``model``).

A `TensorParallel` carries the model axis's ranks (an `AxisRanks` over the
model group of a `MeshRanks` layout) and the rule table. Rank ``m`` of
``M`` holds the contiguous block `block_range` of every dimension whose
logical axis the table maps to ``model``: an uneven split gives the first
``n % M`` ranks one entry more (starcoder2-7b's 36 heads over 16; the
reference pads them to 48, the same function). The two Megatron
boundaries are autograd functions:

* `TensorParallel.copy_in`: forward the identity; backward the sum of the
  cotangent over the model ranks (a replicated input to a column-parallel
  region, whose gradient each rank holds only in part);
* `TensorParallel.sum_out`: forward the sum of every rank's partial
  result; backward the identity (the output of a row-parallel
  contraction).

Every sum is an all-gather followed by `ranks.stack_sum` in rank order,
never ``all_reduce``: every rank then holds the same bits, and over one
rank the sum is ``0 + x``, the value itself. `TensorParallel.gather_dim`
gathers the blocks of one dimension into the whole (uneven blocks pad to
the largest; a checkpoint's gather). Each collective of a step is counted
in ``counts``, its bytes (this rank's contribution) in ``sent``, and its
span on the clock of the rank's device in the current step's ``marks``
(`new_step` opens a step), so that each step is charged its model-axis
time (`step_ms`).

An MoE layer (`models.moe.moe_apply`) holds this rank's experts where M
divides the expert count, else this rank's block of every expert's width;
its router and dispatch run replicated on every rank, and one *sum out*
ends it. Layers with Mamba or xLSTM mixers have no model-axis form here:
`check_model_axis` refuses them at ``M > 1`` by name.
"""

from __future__ import annotations

import collections
import time

import torch

from repro_torch.distributed.ranks import stack_sum

__all__ = ["TensorParallel", "block_range", "check_model_axis", "splits_model"]


def block_range(n: int, world: int, rank: int) -> tuple[int, int]:
    """The contiguous block ``[lo, hi)`` of ``n`` entries that rank
    ``rank`` of ``world`` holds: the first ``n % world`` ranks hold one
    entry more (`torch.tensor_split`'s blocks)."""
    base, extra = divmod(int(n), int(world))
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (1 if rank < extra else 0)


def splits_model(entry) -> bool:
    """Whether a rule table's entry (a mesh-axis name, a tuple of names or
    None) places its axis on ``model``."""
    return entry == "model" or (isinstance(entry, (tuple, list)) and "model" in entry)


def check_model_axis(cfg, model_axis: int) -> None:
    """Refuse, by name, a config whose layers the model axis cannot split
    yet (Mamba and xLSTM mixers) at ``model_axis > 1``."""
    if model_axis <= 1:
        return
    specs = tuple(cfg.pattern) + tuple(cfg.tail)
    kinds = sorted({s.mixer for s in specs if s.mixer in ("mamba", "mlstm", "slstm")})
    if kinds:
        raise ValueError(f"{cfg.name} has {', '.join(kinds)} layers: the model axis over {model_axis} ranks splits "
                         "attention, dense-MLP and MoE layers only (Mamba and xLSTM parallelism are not built)")


class TensorParallel:
    """The model axis over ranks (``ranks``, an `AxisRanks` of the model
    group) under the rule table ``table``."""

    def __init__(self, ranks, table: dict):
        self.ranks = ranks
        self.table = dict(table)
        self.counts: collections.Counter = collections.Counter()
        self.sent = 0
        self.marks: list[list[tuple]] = [[]]

    def __repr__(self) -> str:
        return f"TensorParallel(rank={self.rank}, world={self.world})"

    @property
    def rank(self) -> int:
        return self.ranks.rank

    @property
    def world(self) -> int:
        return self.ranks.world

    def splits(self, name: str) -> bool:
        """Whether the logical axis ``name`` is split over the model ranks."""
        return splits_model(self.table.get(name))

    def range(self, n: int) -> tuple[int, int]:
        """This rank's block ``[lo, hi)`` of an axis of ``n`` entries."""
        return block_range(n, self.world, self.rank)

    # -- the collectives ----------------------------------------------------------

    def _mark(self):
        if self.ranks.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _collective(self, x: torch.Tensor, name: str, add: bool) -> torch.Tensor:
        """Every model rank's ``x`` stacked in rank order (``add``: and
        summed), counted, its bytes and span charged to the step."""
        start = self._mark()
        out = self.ranks._all_gather(x)
        if add:
            out = stack_sum(out)
        self.marks[-1].append((start, self._mark()))
        self.counts[name] += 1
        self.sent += x.numel() * x.element_size()
        return out

    def sum(self, x: torch.Tensor, name: str = "sum") -> torch.Tensor:
        """Every model rank's ``x`` added in rank order onto zeros."""
        return self._collective(x, name, True)

    def gather(self, x: torch.Tensor, name: str = "gather") -> torch.Tensor:
        """Every model rank's ``x``, stacked: ``[world, *x.shape]``."""
        return self._collective(x, name, False)

    def gather_dim(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """The whole of an axis of ``n`` entries at ``dim`` from every rank's
        block of it (`block_range`); no gradient. Not a step's collective
        (a checkpoint's gather): counted in ``ranks.counts``, not charged
        to the step."""
        x = x.detach().movedim(dim, 0)
        widest = block_range(n, self.world, 0)[1]
        pad = torch.zeros((widest,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        pad[:x.shape[0]] = x
        self.ranks.counts["gather_dim"] += 1
        parts = self.ranks._all_gather(pad)
        whole = torch.cat([parts[r, :hi - lo] for r, (lo, hi) in
                           enumerate(block_range(n, self.world, r) for r in range(self.world))])
        return whole.movedim(0, dim)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """Forward ``x``; backward the cotangent summed over the model ranks."""
        return _CopyIn.apply(x, self)

    def sum_out(self, x: torch.Tensor) -> torch.Tensor:
        """Forward every rank's partial ``x`` summed; backward the identity."""
        return _SumOut.apply(x, self)

    # -- the step's accounting ------------------------------------------------------

    def new_step(self) -> None:
        """Charge the collectives from here on to a new step."""
        self.marks.append([])

    def step_ms(self) -> list[float]:
        """The ms each step's collectives took, a step a `new_step` (CUDA
        events on a card, read once the card is synchronized; the host
        clock on the CPU). Read after the run."""
        steps = [m for m in self.marks if m]
        if self.ranks.device.type == "cuda":
            torch.cuda.synchronize(self.ranks.device)
            return [sum(a.elapsed_time(b) for a, b in m) for m in steps]
        return [sum((b - a) * 1e3 for a, b in m) for m in steps]


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.sum(g.contiguous(), "copy_in"), None


class _SumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.sum(x.contiguous(), "sum_out")

    @staticmethod
    def backward(ctx, g):
        return g, None

"""The LM stack's model axis over ranks: tensor and vocabulary parallelism
for attention and dense-MLP layers, expert parallelism (or tensor
parallelism inside each expert) for MoE layers, and sequence parallelism
of the residual stream between them: the port's counterpart of what GSPMD
inserts from the reference's rules (`distributed.sharding.rules_for`:
``heads``, ``kv_heads``, ``mlp``, ``vocab`` and ``experts`` or
``expert_mlp`` map to ``model``, and in training ``seq`` too).

A `TensorParallel` carries the model axis's ranks (an `AxisRanks` over the
model group of a `MeshRanks` layout) and the rule table. Rank ``m`` of
``M`` holds the contiguous block `block_range` of every dimension whose
logical axis the table maps to ``model``: an uneven split gives the first
``n % M`` ranks one entry more (starcoder2-7b's 36 heads over 16; the
reference pads them to 48, the same function). A model region (attention,
MLP, MoE, the head) is entered through one boundary and left through
another (`TensorParallel.enter`, `TensorParallel.leave`), each an autograd
function. Where the table puts ``seq`` nowhere (whisper, decode, a table a
test builds) every rank holds the whole stream:

* `copy_in`: forward the identity; backward the sum of the cotangent over
  the model ranks (a replicated input to a column-parallel region, whose
  gradient each rank holds only in part);
* `sum_out`: forward the sum of every rank's partial result; backward the
  identity (the output of a row-parallel contraction).

Where it puts ``seq`` on ``model`` (training) each rank holds its block of
the sequence (`block_range` of S) between the regions:

* `seq_gather` (into a column-parallel region): forward the all-gather of
  the blocks along the sequence; backward the sum of the cotangent over
  the ranks, of which the rank keeps its block (a reduce-scatter);
* `seq_scatter` (out of a row-parallel region): forward the sum of the
  partial results, of which the rank keeps its block; backward the
  all-gather of the cotangent's blocks;
* `seq_split`: forward the rank's block; backward the all-gather (the
  stream once, after the embedding and a multimodal prefix);
* `seq_share` (into a region every rank computes whole, as the heads of a
  config with fewer heads than ranks): forward the all-gather; backward
  the rank's block of the cotangent, which is whole on every rank.

A parameter that every rank reads on its own rows only (a norm's scale
under ``seq``) passes through `copy_in`, so that its gradient is summed
over the ranks and the leaf stays the same on every rank.

Every sum is an all-gather followed by `ranks.stack_sum` in rank order,
never ``all_reduce``: every rank then holds the same bits, and over one
rank the sum is ``0 + x``, the value itself. Uneven blocks cross padded to
the widest. `TensorParallel.gather_dim` gathers the blocks of one
dimension into the whole (a checkpoint's gather). Each collective of a
step is counted in ``counts`` under its boundary's name (a sequence
boundary's backward under that name with ``_grad`` appended: it runs once
a boundary a step, where the forward runs again in a remat recompute),
its bytes (this rank's contribution) in ``sent``, and its span on the
clock of the rank's device in the current step's ``marks`` (`new_step`
opens a step), so that each step is charged its model-axis time
(`step_ms`); `StepCollectives` holds that accounting, which the data
axis's `distributed.fsdp.FSDP` shares.

An MoE layer (`models.moe.moe_apply`) holds this rank's experts where M
divides the expert count, else this rank's block of every expert's width;
its router and dispatch run replicated on every rank over the whole
sequence, and one *sum out* (under ``seq``, one `seq_scatter`) ends it.
Layers with Mamba or xLSTM mixers have no model-axis form here:
`check_model_axis` refuses them at ``M > 1`` by name.
"""

from __future__ import annotations

import collections
import time

import torch

from repro_torch.distributed.ranks import block_range, stack_sum

__all__ = ["StepCollectives", "TensorParallel", "block_range", "check_model_axis", "splits_model"]


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


class StepCollectives:
    """The collectives of one mesh axis's ranks (``ranks``, an `AxisRanks`)
    charged to training steps: each counted by name in ``counts``, its
    bytes (this rank's contribution) added to ``sent``, its span on the
    clock of the rank's device kept in the current step's ``marks``."""

    def __init__(self, ranks):
        self.ranks = ranks
        self.counts: collections.Counter = collections.Counter()
        self.sent = 0
        self.marks: list[list[tuple]] = [[]]

    @property
    def rank(self) -> int:
        return self.ranks.rank

    @property
    def world(self) -> int:
        return self.ranks.world

    def range(self, n: int) -> tuple[int, int]:
        """This rank's block ``[lo, hi)`` of an axis of ``n`` entries."""
        return block_range(n, self.world, self.rank)

    def _mark(self):
        if self.ranks.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _charge(self, start, name: str, nbytes: int) -> None:
        self.marks[-1].append((start, self._mark()))
        self.counts[name] += 1
        self.sent += nbytes

    def _collective(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order, counted, its bytes and
        span charged to the step."""
        start = self._mark()
        out = self.ranks._all_gather(x)
        self._charge(start, name, x.numel() * x.element_size())
        return out

    def sum(self, x: torch.Tensor, name: str = "sum") -> torch.Tensor:
        """Every rank's ``x`` added in rank order onto zeros."""
        return stack_sum(self._collective(x, name))

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


class TensorParallel(StepCollectives):
    """The model axis over ranks (``ranks``, an `AxisRanks` of the model
    group) under the rule table ``table``; ``seq``: the table puts the
    sequence on ``model``, and the stream between the regions is this
    rank's block of ``seq_len`` positions (set by `seq_split`)."""

    def __init__(self, ranks, table: dict):
        super().__init__(ranks)
        self.table = dict(table)
        self.seq = splits_model(self.table.get("seq"))
        self.seq_len: int | None = None

    def __repr__(self) -> str:
        return f"TensorParallel(rank={self.rank}, world={self.world})"

    def splits(self, name: str) -> bool:
        """Whether the logical axis ``name`` is split over the model ranks."""
        return splits_model(self.table.get(name))

    # -- the collectives ----------------------------------------------------------

    def gather(self, x: torch.Tensor, name: str = "gather") -> torch.Tensor:
        """Every model rank's ``x``, stacked: ``[world, *x.shape]``."""
        return self._collective(x, name)

    def gather_dim(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """The whole of an axis of ``n`` entries at ``dim`` from every rank's
        block of it (`block_range`); no gradient. Not a step's collective
        (a checkpoint's gather): counted in ``ranks.counts``, not charged
        to the step."""
        return self.ranks.gather_dim(x.detach(), dim, n)

    def _seq_blocks(self, n: int | None) -> list[tuple[int, int]]:
        if n is None:
            raise RuntimeError("the sequence crosses the model ranks only after seq_split has cut the stream")
        return [block_range(n, self.world, r) for r in range(self.world)]

    def gather_seq(self, x: torch.Tensor, name: str, n: int) -> torch.Tensor:
        """The whole sequence (dim 1) of ``n`` positions from every rank's
        block of it."""
        blocks = self._seq_blocks(n)
        widest = blocks[0][1]
        if x.shape[1] != widest:
            pad = x.new_zeros((x.shape[0], widest) + tuple(x.shape[2:]))
            pad[:, :x.shape[1]] = x
            x = pad
        parts = self._collective(x.contiguous(), name)
        if self.world == 1:
            return parts[0]
        return torch.cat([parts[r, :, :hi - lo] for r, (lo, hi) in enumerate(blocks)], dim=1)

    def scatter_seq(self, x: torch.Tensor, name: str, n: int) -> torch.Tensor:
        """This rank's block of the sequence (dim 1, ``n`` positions) of
        every rank's ``x`` (the whole sequence) added in rank order onto
        zeros."""
        lo, hi = self._seq_blocks(n)[self.rank]
        return stack_sum(self._collective(x.contiguous(), name)[:, :, lo:hi])

    # -- the boundaries -------------------------------------------------------------

    def copy_in(self, x: torch.Tensor, name: str = "copy_in") -> torch.Tensor:
        """Forward ``x``; backward the cotangent summed over the model ranks,
        counted as ``name``."""
        return _CopyIn.apply(x, self, name)

    def sum_out(self, x: torch.Tensor) -> torch.Tensor:
        """Forward every rank's partial ``x`` summed; backward the identity."""
        return _SumOut.apply(x, self)

    def seq_split(self, x: torch.Tensor) -> torch.Tensor:
        """Forward this rank's block of the sequence (dim 1) of the whole
        ``x``, which sets ``seq_len``; backward the cotangent's blocks
        all-gathered."""
        self.seq_len = x.shape[1]
        return _SeqSplit.apply(x, self)

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Forward the whole sequence from the blocks; backward the
        cotangent summed over the model ranks, this rank's block of it."""
        return _SeqGather.apply(x, self)

    def seq_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Forward this rank's block of every rank's partial ``x`` summed;
        backward the cotangent's blocks all-gathered."""
        return _SeqScatter.apply(x, self)

    def seq_share(self, x: torch.Tensor) -> torch.Tensor:
        """Forward the whole sequence from the blocks, into a region that
        every rank computes whole; backward this rank's block of the
        cotangent (the same whole on every rank)."""
        return _SeqShare.apply(x, self)

    def seq_gather_pair(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One all-gather of the sequence read two ways: the first as
        `seq_gather`'s (a column-parallel input: its cotangent is summed
        over the ranks), the second as `seq_share`'s (a replicated input:
        its cotangent is whole on every rank, and this rank keeps its
        block); the backward adds the two in that order."""
        return _SeqGatherPair.apply(x, self)

    def enter(self, x: torch.Tensor, split: bool) -> torch.Tensor:
        """``x`` into a region whose weights are cut over the model ranks
        (``split``) or whole on every rank."""
        if self.seq:
            return self.seq_gather(x) if split else self.seq_share(x)
        return self.copy_in(x) if split else x

    def leave(self, y: torch.Tensor, split: bool) -> torch.Tensor:
        """A region's output back onto the stream: every rank's part summed
        (``split``), or the whole on every rank; this rank's block of it
        under ``seq``."""
        if self.seq:
            return self.seq_scatter(y) if split else self.seq_split(y)
        return self.sum_out(y) if split else y


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, name):
        ctx.tp, ctx.name = tp, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.sum(g.contiguous(), ctx.name), None, None


class _SumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.sum(x.contiguous(), "sum_out")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SeqSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, tp.seq_len
        lo, hi = tp._seq_blocks(ctx.n)[tp.rank]
        return x[:, lo:hi].clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.gather_seq(g, "seq_split_grad", ctx.n), None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, tp.seq_len
        return tp.gather_seq(x, "seq_gather", ctx.n)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.scatter_seq(g, "seq_gather_grad", ctx.n), None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, tp.seq_len
        return tp.scatter_seq(x, "seq_scatter", ctx.n)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.gather_seq(g, "seq_scatter_grad", ctx.n), None


class _SeqShare(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, tp.seq_len
        return tp.gather_seq(x, "seq_share", ctx.n)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.tp._seq_blocks(ctx.n)[ctx.tp.rank]
        return g[:, lo:hi], None


class _SeqGatherPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, tp.seq_len
        whole = tp.gather_seq(x, "seq_gather", ctx.n)
        return whole, whole.view_as(whole)

    @staticmethod
    def backward(ctx, g_split, g_shared):
        tp = ctx.tp
        lo, hi = tp._seq_blocks(ctx.n)[tp.rank]
        return tp.scatter_seq(g_split, "seq_gather_grad", ctx.n) + g_shared[:, lo:hi], None

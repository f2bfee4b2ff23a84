"""Train-step builder: loss -> grads -> clip -> AdamW, with the MoE aux
loss. Counterpart of `repro.train.step`.

The state is ``{"params", "opt": {"mu", "nu", "count"}, "step"}``, the
reference's tree with the same leaf names. The step updates it in place
(`optim.adamw_update_`): the parameters, both float32 moments and the two
counters, which stay device tensors, so a step reads nothing back to the
host. With ``microbatches = k`` the batch is cut into k along its rows, and
the float32 gradients ``acc += g.float() / k`` are summed in the
reference's order; the metrics are the mean over the microbatches.

Data-parallel over ranks (``ranks``, a `distributed.ranks.AxisRanks` on
the ``data`` axis, one data shard a rank): each rank's batch is its shard
of the global batch, one microbatch of the reference's accumulation over
``D = world`` (which ``microbatches = k`` splits further), and the step is
the one-process step at ``microbatches = D k``: with ``K = D k`` of 1 the
gradients stay in the parameters' dtype, else each contributes ``g / K``
in float32; the ranks' contributions are summed in rank order from zeros
(`AxisRanks.reduce_sum_`, a chunk of at most `ranks.GATHER_CHUNK_BYTES` a
rank at a time, so the temporaries stay within ``(world + 1)`` chunks),
the metrics are gathered and averaged over the stack, and every rank takes
the same `adamw_update_`, so the replicas stay bit-equal. With k = 1 that
is the one-process step at ``microbatches = D`` bit for bit; with k > 1 the
float32 sums group by rank, within rounding of it. The MoE load-balance
term is each microbatch's own, as in the reference's microbatched step.
The launcher runs its ranks over a layout (below) instead, a data axis
alone as D x 1; this replicated step is the one the layouts are held to.

Over a (data, model) layout (``ranks``, a `distributed.ranks.MeshRanks`
of D·M ranks) both axes are spread: the step installs the rule table of
`rules_for` for the (D, M) mesh with the ranks in it (`model_rules`).
Over the model ranks (`distributed.tensor_parallel`) every attention,
MLP and vocabulary matrix, and every MoE layer's experts (or each
expert's width), is this rank's block, and in training the residual
stream is this rank's block of the sequence between the regions. Over the
data ranks (`distributed.fsdp`, the ``fsdp`` rule) each layer matrix and
its two moments are this rank's slice, gathered whole where a layer reads
it. The state holds the blocks (`init_train_state(..., rules=...)`,
`state_blocks`). An ``fsdp`` leaf's gradient is summed over the data
group by its gather's backward, in rank order, and lands as this rank's
slice in the step's accumulator (`FSDP.bound`); every other leaf is summed
over the data group by `AxisRanks.reduce_sum_` as above. The gradient
norm adds the squares of the leaves cut over the data ranks over the data
group, then those of the leaves cut over the model ranks over the model
group, each in rank order, and counts a leaf cut over neither once. A
norm's scale reads only this rank's rows under sequence parallelism; its
gradient is summed over the model ranks (`models.common.rmsnorm`), so
that every replicated leaf's gradient (a norm's scale, a router) is the
same whole on every model rank. The row-parallel contractions add their
partial sums in a new order and the norm's squares group by slice, so the
step is the one-process step within rounding at D > 1 or M > 1, and bit
for bit at D = M = 1, where every gather is the block and every sum over
a group is ``0 + x``. With ``microbatches = k > 1`` an ``fsdp`` leaf's
float32 sum groups by microbatch (each microbatch's contributions summed
over the ranks, then the microbatches added), the other leaves' by rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from repro_torch.distributed.fsdp import FSDP
from repro_torch.distributed.ranks import MeshRanks
from repro_torch.distributed.sharding import ModelBlocks, Rules, data_dim, rules_for, use_rules
from repro_torch.distributed.tensor_parallel import TensorParallel, check_model_axis
from repro_torch.models import ModelConfig, cross_entropy, forward, init_params
from repro_torch.models.transformer import param_axes
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, ScheduleConfig, adamw_init, adamw_update_, lr_schedule

__all__ = ["StepClock", "TrainConfig", "init_train_state", "make_train_step", "model_rules", "state_blocks"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    moe_aux_weight: float = 0.01
    z_loss: float = 1e-4
    # gradient accumulation: activations scale with batch / microbatches
    # while the total compute is unchanged
    microbatches: int = 1


class StepClock:
    """Marks the start and end of each call of a wrapped function: CUDA
    events on a card, the host clock on the CPU. Read ``ms()`` after the
    run."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: list[tuple] = []

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wrap(self, fn):
        def timed(*args):
            start = self._mark()
            out = fn(*args)
            self.marks.append((start, self._mark()))
            return out
        return timed

    def ms(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


def model_rules(model_cfg: ModelConfig, ranks: MeshRanks) -> Rules:
    """The rule table of `rules_for` for the (D, M) mesh of ``ranks``, with
    the model axis over its model ranks (attention heads, MLP widths and
    the vocabulary, an MoE layer's experts where M divides their count,
    else every expert's width, and the sequence in training) and the
    ``fsdp`` rule over its data ranks. Refuses, by name, a config whose
    layers the model axis cannot split at M > 1 (Mamba, xLSTM:
    `check_model_axis`)."""
    d, m = ranks.shape
    check_model_axis(model_cfg, m)
    table = rules_for(model_cfg, mode="train", multi_pod=False, data_axis=d, model_axis=m)
    shards = None
    if data_dim(("fsdp",), table) is not None:
        shards = FSDP(ranks.data, table, param_axes(model_cfg), init_params(None, model_cfg, device="meta"))
    return Rules(table, {"data": d, "model": m}, model=TensorParallel(ranks.model, table), data=shards)


def state_axes(model_cfg: ModelConfig) -> dict:
    """The logical axes of the train state's tree."""
    pa = param_axes(model_cfg)
    return {"params": pa, "opt": {"mu": pa, "nu": pa, "count": ()}, "step": ()}


def param_blocks(model_cfg: ModelConfig, rules: Rules) -> ModelBlocks:
    """The parameters' blocks over the model and data ranks of ``rules``."""
    return ModelBlocks(param_axes(model_cfg), init_params(None, model_cfg, device="meta"), rules)


def state_blocks(model_cfg: ModelConfig, rules: Rules) -> ModelBlocks:
    """The train state's blocks over the model and data ranks of
    ``rules``: its cut and its gather into the whole state (checkpoints
    write the whole)."""
    params = init_params(None, model_cfg, device="meta")
    whole = {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32, device="meta")}
    return ModelBlocks(state_axes(model_cfg), whole, rules)


def init_train_state(gen, model_cfg: ModelConfig, *, device=None, rules: Rules | None = None) -> dict:
    """Parameters of ``model_cfg`` from ``gen`` on ``device`` (default
    ``cuda``, which must exist), zero moments and a zero step counter. With
    ``rules`` carrying the model or data axis over ranks (`model_rules`)
    the parameters are made whole, then cut to this rank's block, and the
    moments are the block's."""
    params = init_params(gen, model_cfg, device=device)
    if rules is not None and (rules.model is not None or rules.data is not None):
        params = param_blocks(model_cfg, rules).cut(params)
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _like(tree, values):
    """``tree``'s structure with its leaves (in `tree_leaves` order)
    replaced by ``values``."""
    by_leaf = {id(leaf): v for leaf, v in zip(tree_leaves(tree), values, strict=True)}
    return tree_map(lambda leaf: by_leaf[id(leaf)], tree)


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig, ranks=None):
    """``train_step(state, batch) -> (state, metrics)``: one optimizer step,
    written into ``state`` (which is returned). ``batch``: ``inputs`` and
    ``targets`` (B, S), optional ``mask``, ``frames`` (whisper) and
    ``prefix_embeddings`` (llava), on the state's device.

    Over ``ranks`` (the data axis, one shard a rank; or a `MeshRanks`
    layout, whose data axis that is) ``batch`` is this rank's data shard
    (`data.shard_batch_at`), and ``train_step.reduction`` (a `StepClock`)
    times each step's gradient reduction, whose bytes a rank (its
    contribution, gathered by every other rank) are in
    ``train_step.reduce_bytes``. Over a `MeshRanks` layout the state is
    this rank's block (`init_train_state(..., rules=train_step.rules)`),
    and ``train_step.rules.model`` (a `TensorParallel`) counts and times
    the model axis's collectives, a step a call."""
    mesh = ranks if isinstance(ranks, MeshRanks) else None
    if mesh is not None:
        ranks = mesh.data
    if ranks is not None and (ranks.axis != "data" or ranks.n != ranks.world):
        raise ValueError(f"a data-parallel step takes one data shard a rank, not {ranks!r}")
    n_data = 1 if ranks is None else ranks.world
    rules = tp = fs = cut = None
    cuts = ()  # the leaves' cuts over the data axis, then the model axis: the gradient norm's sums
    if mesh is not None:
        rules = model_rules(model_cfg, mesh)
        tp, fs = rules.model, rules.data
        blocks = param_blocks(model_cfg, rules)
        cut = [d is not None for d in blocks.data_dims]
        cuts = ([] if fs is None else [(fs, cut)]) + [(tp, [d is not None for d in blocks.dims])]

    def loss_fn(params, batch):
        aux: dict = {}
        kwargs = {k: batch[k] for k in ("frames", "prefix_embeddings") if k in batch}
        logits = forward(params, batch["inputs"], model_cfg, aux=aux, **kwargs)
        # multimodal prefix: the loss only on the token positions (suffix)
        if "prefix_embeddings" in batch:
            logits = logits[:, batch["prefix_embeddings"].shape[1]:]
        loss, metrics = cross_entropy(logits, batch["targets"], batch.get("mask"), z_loss=train_cfg.z_loss,
                                      vocab_size=model_cfg.vocab_size)
        if "moe_load_balance" in aux:
            loss = loss + train_cfg.moe_aux_weight * aux["moe_load_balance"]
            metrics["moe_load_balance"] = aux["moe_load_balance"]
            metrics["moe_dropped_frac"] = aux["moe_dropped_frac"]
        return loss, {k: v.detach() for k, v in metrics.items()}

    def value_and_grad(params, batch, sinks=None):
        """(metrics, grads) with the grads of every leaf of ``params``, taken
        through aliases of the leaves (the state's tensors never require
        grad). A leaf the loss does not reach gets zeros, as under
        `jax.grad` (whisper's encoder without frames). With ``sinks`` (in
        leaf order, `FSDP.sinks`) an ``fsdp`` leaf's gradient is added,
        summed over the data ranks, into its sink, and its grad is None."""
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        bound = fs.bound(leaves, sinks) if sinks is not None else contextlib.nullcontext()
        with torch.enable_grad(), use_rules(rules) if rules is not None else contextlib.nullcontext(), bound:
            loss, metrics = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        sunk = sinks or [None] * len(leaves)
        return metrics, _like(live, [None if s is not None else torch.zeros_like(leaf) if g is None else g
                                     for leaf, g, s in zip(leaves, grads, sunk)])

    def reduce(grads, ms):
        """Every rank's gradients summed in rank order, into ``grads`` (an
        ``fsdp`` leaf's already summed by its gather's backward); the
        metrics' mean over every rank's microbatches."""
        leaves = tree_leaves(grads)
        train_step.reduce_bytes = ranks.reduce_sum_(leaves if cut is None else
                                                    [g for g, c in zip(leaves, cut) if not c])
        with torch.no_grad():
            return {name: torch.mean(ranks.gather(torch.stack([m[name] for m in ms])[None]).reshape(-1), dim=0)
                    for name in ms[0]}

    def train_step(state, batch):
        if tp is not None:
            tp.new_step()
        if fs is not None:
            fs.new_step()
        k = train_cfg.microbatches
        total = n_data * k
        params = state["params"]
        sinks = None
        if fs is not None:  # each fsdp leaf's slice of the summed gradient, in the step's accumulation dtype
            sinks = fs.sinks(tree_leaves(params), cut, None if total == 1 else total)
        if total == 1:
            m, grads = value_and_grad(params, batch, sinks)
            ms = [m]
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % k:
                raise ValueError(f"a batch of {rows} rows does not split into {k} microbatches")
            sunk = sinks or [None] * len(tree_leaves(params))
            grads = _like(params, [None if s is not None else torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                   for p, s in zip(tree_leaves(params), sunk)])
            ms = []
            for i in range(k):
                one = {name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i] for name, x in batch.items()}
                m, g = value_and_grad(params, one, sinks)
                for acc, gg in zip(tree_leaves(grads), tree_leaves(g)):
                    if acc is not None:
                        acc.add_(gg.to(torch.float32) / total)
                del g
                ms.append(m)
        if sinks is not None:  # the fsdp leaves' slices, summed over the data ranks by their gathers' backward
            grads = _like(params, [g if s is None else s.value() for g, s in zip(tree_leaves(grads), sinks)])
        if ranks is not None:
            if total == 1:  # the reduction sums contiguous leaves in place
                grads = tree_map(lambda g: g.contiguous(), grads)
            metrics = reduction(grads, ms)
        elif total == 1:
            metrics = ms[0]
        else:
            metrics = {name: torch.mean(torch.stack([m[name] for m in ms]), dim=0) for name in ms[0]}

        lr_scale = lr_schedule(state["step"], train_cfg.schedule)
        opt_metrics = adamw_update_(grads, state["opt"], params, train_cfg.optimizer, lr_scale=lr_scale, cuts=cuts)
        del grads, sinks
        state["step"].add_(1)
        return state, dict(metrics, **opt_metrics, lr_scale=lr_scale)

    train_step.rules = rules
    if ranks is not None:
        train_step.reduction = StepClock(ranks.device)
        train_step.reduce_bytes = 0
        reduction = train_step.reduction.wrap(reduce)
    return train_step

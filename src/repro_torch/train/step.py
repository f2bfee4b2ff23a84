"""Train-step builder: loss -> grads -> clip -> AdamW, with the MoE aux
loss. Counterpart of `repro.train.step`.

The state is ``{"params", "opt": {"mu", "nu", "count"}, "step"}``, the
reference's tree with the same leaf names. The step updates it in place
(`optim.adamw_update_`): the parameters, both float32 moments and the two
counters, which stay device tensors, so a step reads nothing back to the
host. With ``microbatches = k`` the batch is cut into k along its rows, and
the float32 gradients ``acc += g.float() / k`` are summed in the
reference's order; the metrics are the mean over the microbatches.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import ModelConfig, cross_entropy, forward, init_params
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, ScheduleConfig, adamw_init, adamw_update_, lr_schedule

__all__ = ["TrainConfig", "init_train_state", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    moe_aux_weight: float = 0.01
    z_loss: float = 1e-4
    # gradient accumulation: activations scale with batch / microbatches
    # while the total compute is unchanged
    microbatches: int = 1


def init_train_state(gen, model_cfg: ModelConfig, *, device=None) -> dict:
    """Parameters of ``model_cfg`` from ``gen`` on ``device`` (default
    ``cuda``, which must exist), zero moments and a zero step counter."""
    params = init_params(gen, model_cfg, device=device)
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """``train_step(state, batch) -> (state, metrics)``: one optimizer step,
    written into ``state`` (which is returned). ``batch``: ``inputs`` and
    ``targets`` (B, S), optional ``mask``, ``frames`` (whisper) and
    ``prefix_embeddings`` (llava), on the state's device."""

    def loss_fn(params, batch):
        aux: dict = {}
        kwargs = {k: batch[k] for k in ("frames", "prefix_embeddings") if k in batch}
        logits = forward(params, batch["inputs"], model_cfg, aux=aux, **kwargs)
        # multimodal prefix: the loss only on the token positions (suffix)
        if "prefix_embeddings" in batch:
            logits = logits[:, batch["prefix_embeddings"].shape[1]:]
        loss, metrics = cross_entropy(logits, batch["targets"], batch.get("mask"), z_loss=train_cfg.z_loss)
        if "moe_load_balance" in aux:
            loss = loss + train_cfg.moe_aux_weight * aux["moe_load_balance"]
            metrics["moe_load_balance"] = aux["moe_load_balance"]
            metrics["moe_dropped_frac"] = aux["moe_dropped_frac"]
        return loss, {k: v.detach() for k, v in metrics.items()}

    def value_and_grad(params, batch):
        """(metrics, grads) with the grads of every leaf of ``params``, taken
        through aliases of the leaves (the state's tensors never require
        grad). A leaf the loss does not reach gets zeros, as under
        `jax.grad` (whisper's encoder without frames)."""
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            loss, metrics = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        by_leaf = {id(leaf): g for leaf, g in zip(leaves, grads)}
        return metrics, tree_map(lambda leaf: by_leaf[id(leaf)], live)

    def train_step(state, batch):
        k = train_cfg.microbatches
        params = state["params"]
        if k == 1:
            metrics, grads = value_and_grad(params, batch)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % k:
                raise ValueError(f"a batch of {rows} rows does not split into {k} microbatches")
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            ms = []
            for i in range(k):
                one = {name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i] for name, x in batch.items()}
                m, g = value_and_grad(params, one)
                for acc, gg in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gg.to(torch.float32) / k)
                del g
                ms.append(m)
            metrics = {name: torch.mean(torch.stack([m[name] for m in ms]), dim=0) for name in ms[0]}

        lr_scale = lr_schedule(state["step"], train_cfg.schedule)
        opt_metrics = adamw_update_(grads, state["opt"], params, train_cfg.optimizer, lr_scale=lr_scale)
        del grads
        state["step"].add_(1)
        return state, dict(metrics, **opt_metrics, lr_scale=lr_scale)

    return train_step

"""Dense FFN: SwiGLU (llama-family) or GELU (whisper/starcoder-family).
Counterpart of `repro.models.mlp`."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain, tensor_parallel
from repro_torch.models.common import ModelConfig, ParamInit, dense_init, gelu


def mlp_init(init: ParamInit, cfg: ModelConfig, d_ff: int | None = None):
    d_ff = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gate": dense_init(init, (cfg.d_model, d_ff), cfg.dtype),
            "w_up": dense_init(init, (cfg.d_model, d_ff), cfg.dtype),
            "w_down": dense_init(init, (d_ff, cfg.d_model), cfg.dtype),
        }
    return {
        "w_up": dense_init(init, (cfg.d_model, d_ff), cfg.dtype),
        "w_down": dense_init(init, (d_ff, cfg.d_model), cfg.dtype),
    }


def mlp_axes(cfg: ModelConfig):
    if cfg.act == "swiglu":
        return {"w_gate": ("fsdp", "mlp"), "w_up": ("fsdp", "mlp"), "w_down": ("mlp", "fsdp")}
    return {"w_up": ("fsdp", "mlp"), "w_down": ("mlp", "fsdp")}


def mlp_apply(params, x, cfg: ModelConfig):
    """With ``mlp`` on the model axis over ranks, ``w_gate`` and ``w_up``
    are column-parallel and ``w_down`` row-parallel, one sum over the model
    ranks after it (under sequence parallelism the region takes the
    gathered sequence and leaves the rank's block of the sum)."""
    tp = tensor_parallel()
    split = tp is not None and tp.splits("mlp")
    if tp is not None:
        x = tp.enter(x, split)
    if cfg.act == "swiglu":
        h = F.silu(torch.einsum("bsd,df->bsf", x, params["w_gate"])) * torch.einsum("bsd,df->bsf", x, params["w_up"])
    else:
        h = gelu(torch.einsum("bsd,df->bsf", x, params["w_up"]))
    h = constrain(h, "batch", None, "mlp")
    y = torch.einsum("bsf,fd->bsd", h, params["w_down"])
    return y if tp is None else tp.leave(y, split)

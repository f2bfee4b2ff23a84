"""Architecture registry: ``--arch <id>`` resolution and the input specs of
each shape cell. Counterpart of `repro.configs.registry`."""

from __future__ import annotations

import torch

from repro_torch.configs import (
    deepseek_moe_16b,
    gemma3_27b,
    jamba_v0p1_52b,
    llava_next_mistral_7b,
    mixtral_8x22b,
    phi3_mini_3p8b,
    starcoder2_15b,
    starcoder2_7b,
    whisper_tiny,
    xlstm_1p3b,
)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_supported  # noqa: F401
from repro_torch.models.common import ModelConfig

_MODULES = {
    m.ARCH_ID: m
    for m in (
        deepseek_moe_16b,
        mixtral_8x22b,
        xlstm_1p3b,
        whisper_tiny,
        starcoder2_15b,
        starcoder2_7b,
        gemma3_27b,
        phi3_mini_3p8b,
        jamba_v0p1_52b,
        llava_next_mistral_7b,
    )
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, *, dtype=torch.bfloat16) -> ModelConfig:
    return _MODULES[arch_id].config(dtype=dtype)


def get_smoke_config(arch_id: str, *, dtype=torch.float32) -> ModelConfig:
    return _MODULES[arch_id].smoke_config(dtype=dtype)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Stand-ins on the ``meta`` device (shape and dtype, no allocation) for
    every model input of a shape cell.

    train:   token batch (+ stub frames / patch embeddings)
    prefill: token batch
    decode:  one-token batch + the KV/state caches at shape.seq_len
    """
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    tok = lambda n: torch.empty((b, n), dtype=torch.int32, device=meta)  # noqa: E731
    emb = lambda n: torch.empty((b, n, cfg.d_model), dtype=cfg.dtype, device=meta)  # noqa: E731

    if shape.kind in ("train", "prefill"):
        specs = {"inputs": tok(s)}
        if shape.kind == "train":
            specs["targets"] = tok(s)
        if cfg.encoder_layers:
            # audio stub: precomputed frame embeddings
            specs["frames"] = emb(cfg.encoder_frames)
        if cfg.prefix_tokens:
            # vlm stub: patch embeddings occupy the sequence prefix
            for name in ("inputs", "targets"):
                if name in specs:
                    specs[name] = tok(s - cfg.prefix_tokens)
            specs["prefix_embeddings"] = emb(cfg.prefix_tokens)
        return specs

    if shape.kind == "decode":
        from repro_torch.models.transformer import init_decode_state

        specs = {"tokens": tok(1), "state": init_decode_state(cfg, b, s, cfg.dtype, device=meta)}
        if cfg.encoder_layers:
            specs["enc_out"] = emb(cfg.encoder_frames)
        return specs

    raise ValueError(shape.kind)

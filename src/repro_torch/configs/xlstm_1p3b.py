"""xlstm-1.3b [arXiv:2405.04517]: 48L d2048 4H vocab 50304, d_ff=0
(projections live inside the blocks), mLSTM:sLSTM = 7:1 interleave."""

import torch

from repro_torch.models.common import LayerSpec, ModelConfig

ARCH_ID = "xlstm-1.3b"

_PATTERN = tuple(LayerSpec("mlstm", "none") for _ in range(7)) + (LayerSpec("slstm", "none"),)


def config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        pattern=_PATTERN,
        tie_embeddings=True,
        dtype=dtype,
    )


def smoke_config(dtype=torch.float32) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=128,
        pattern=(LayerSpec("mlstm", "none"), LayerSpec("slstm", "none")),
        dtype=dtype,
    )

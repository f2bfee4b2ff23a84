"""phi3-mini-3.8b [arXiv:2404.14219]: 32L d3072 32H(kv32 = MHA) d_ff 8192
vocab 32064, RoPE + SwiGLU."""

import torch

from repro_torch.models.common import LayerSpec, ModelConfig

ARCH_ID = "phi3-mini-3.8b"


def config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        pattern=(LayerSpec("attn", "mlp"),),
        rope_theta=1e4,
        tie_embeddings=False,
        dtype=dtype,
    )


def smoke_config(dtype=torch.float32) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=128,
        pattern=(LayerSpec("attn", "mlp"),),
        tie_embeddings=False,
        dtype=dtype,
    )

"""starcoder2-7b [arXiv:2402.19173; hf]: 32L d4608 36H(kv4) d_ff 18432
vocab 49152, GQA + RoPE, GELU MLP."""

import torch

from repro_torch.models.common import LayerSpec, ModelConfig

ARCH_ID = "starcoder2-7b"


def config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49152,
        pattern=(LayerSpec("attn", "mlp"),),
        act="gelu",
        rope_theta=1e5,
        tie_embeddings=False,
        dtype=dtype,
    )


def smoke_config(dtype=torch.float32) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=48,
        n_heads=6,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=128,
        pattern=(LayerSpec("attn", "mlp"),),
        act="gelu",
        tie_embeddings=False,
        dtype=dtype,
    )

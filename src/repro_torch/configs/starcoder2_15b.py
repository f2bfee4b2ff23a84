"""starcoder2-15b [arXiv:2402.19173; hf]: 40L d6144 48H(kv4) d_ff 24576
vocab 49152, GQA + RoPE, GELU MLP."""

import torch

from repro_torch.models.common import LayerSpec, ModelConfig

ARCH_ID = "starcoder2-15b"


def config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        head_dim=128,
        d_ff=24576,
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
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=128,
        pattern=(LayerSpec("attn", "mlp"),),
        act="gelu",
        tie_embeddings=False,
        dtype=dtype,
    )

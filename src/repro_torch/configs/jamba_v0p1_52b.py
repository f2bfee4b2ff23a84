"""jamba-v0.1-52b [arXiv:2403.19887; hf]: 32L d4096 32H(kv8) d_ff 14336
vocab 65536, attn:mamba = 1:7 (attention at period position 4), MoE 16e
top-2 on every second layer."""

import torch

from repro_torch.models.common import LayerSpec, ModelConfig, MoEConfig

ARCH_ID = "jamba-v0.1-52b"

_PERIOD = (
    LayerSpec("mamba", "mlp"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "mlp"),
    LayerSpec("mamba", "moe"),
    LayerSpec("attn", "mlp"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "mlp"),
    LayerSpec("mamba", "moe"),
)


def config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        pattern=_PERIOD,
        moe=MoEConfig(n_experts=16, top_k=2, router_scale=True),
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
        tie_embeddings=False,
        dtype=dtype,
    )


def smoke_config(dtype=torch.float32) -> ModelConfig:
    period = (
        LayerSpec("mamba", "mlp"),
        LayerSpec("mamba", "moe"),
        LayerSpec("attn", "mlp"),
        LayerSpec("mamba", "moe"),
    )
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=128,
        pattern=period,
        moe=MoEConfig(n_experts=4, top_k=2, router_scale=True),
        tie_embeddings=False,
        dtype=dtype,
    )

"""deepseek-moe-16b [arXiv:2401.06066; hf]: 28L d2048 16H(kv16) vocab 102400,
fine-grained MoE: 2 shared + 64 routed top-6, expert width 1408."""

import torch

from repro_torch.models.common import LayerSpec, ModelConfig, MoEConfig

ARCH_ID = "deepseek-moe-16b"


def config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        pattern=(LayerSpec("attn", "moe"),),
        moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408, router_scale=True),
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
        d_ff=48,
        vocab_size=128,
        pattern=(LayerSpec("attn", "moe"),),
        moe=MoEConfig(n_experts=8, top_k=3, n_shared=2, d_expert=48, router_scale=True),
        tie_embeddings=False,
        dtype=dtype,
    )

"""mixtral-8x22b [arXiv:2401.04088; hf]: 56L d6144 48H(kv8) d_ff 16384
vocab 32768, 8 experts top-2 (gates renormalized), SWA window 4096."""

import torch

from repro_torch.models.common import LayerSpec, ModelConfig, MoEConfig

ARCH_ID = "mixtral-8x22b"
SWA_WINDOW = 4096


def config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32768,
        pattern=(LayerSpec("swa", "moe", window=SWA_WINDOW),),
        moe=MoEConfig(n_experts=8, top_k=2, router_scale=True),
        rope_theta=1e6,
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
        d_ff=96,
        vocab_size=128,
        pattern=(LayerSpec("swa", "moe", window=8),),
        moe=MoEConfig(n_experts=4, top_k=2, router_scale=True),
        tie_embeddings=False,
        dtype=dtype,
    )

"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf]: mistral-7b
text backbone (32L d4096 32H(kv8) d_ff 14336 vocab 32000) with an anyres
vision frontend STUB per the brief: input_specs provides (B, patches, d)
precomputed patch embeddings prepended to the token sequence (one 24x24
tile = 576 patch slots; loss is computed on the text suffix)."""

import torch

from repro_torch.models.common import LayerSpec, ModelConfig

ARCH_ID = "llava-next-mistral-7b"
PREFIX_TOKENS = 576


def config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        pattern=(LayerSpec("attn", "mlp"),),
        rope_theta=1e6,
        prefix_tokens=PREFIX_TOKENS,
        tie_embeddings=False,
        dtype=dtype,
    )


def smoke_config(dtype=torch.float32) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=128,
        pattern=(LayerSpec("attn", "mlp"),),
        prefix_tokens=8,
        tie_embeddings=False,
        dtype=dtype,
    )

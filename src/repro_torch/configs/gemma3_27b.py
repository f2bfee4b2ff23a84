"""gemma3-27b [hf:google/gemma-3 family]: 62L d5376 32H(kv16, head_dim 128)
d_ff 21504 vocab 262144, 5 local(SWA 1024):1 global interleave, local RoPE
theta 1e4 / global 1e6, embeddings scaled by sqrt(d).

62 = 10 periods of 6 + a 2-layer (local, local) tail — handled by the
model's `tail` stack (scan stays O(period))."""

import torch

from repro_torch.models.common import LayerSpec, ModelConfig

ARCH_ID = "gemma3-27b"
LOCAL_WINDOW = 1024

_PERIOD = tuple(LayerSpec("swa", "mlp", window=LOCAL_WINDOW, rope_theta=1e4) for _ in range(5)) + (
    LayerSpec("attn", "mlp", rope_theta=1e6),
)
_TAIL = (
    LayerSpec("swa", "mlp", window=LOCAL_WINDOW, rope_theta=1e4),
    LayerSpec("swa", "mlp", window=LOCAL_WINDOW, rope_theta=1e4),
)


def config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=60,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        pattern=_PERIOD,
        tail=_TAIL,
        tie_embeddings=True,
        dtype=dtype,
    )


def smoke_config(dtype=torch.float32) -> ModelConfig:
    period = tuple(LayerSpec("swa", "mlp", window=8, rope_theta=1e4) for _ in range(2)) + (
        LayerSpec("attn", "mlp", rope_theta=1e6),
    )
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        pattern=period,
        tail=(LayerSpec("swa", "mlp", window=8, rope_theta=1e4),),
        dtype=dtype,
    )

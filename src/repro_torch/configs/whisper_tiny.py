"""whisper-tiny [arXiv:2212.04356]: enc-dec, 4+4L d384 6H d_ff 1536 GELU,
vocab 51865. The conv audio frontend is a STUB per the brief: input_specs
provides precomputed (B, frames, d) frame embeddings (frames=1500 = 30 s).

Adaptation note (DESIGN.md): positions use RoPE on the decoder and
sinusoidal on the encoder in place of Whisper's learned absolute
embeddings — structural proxy with identical compute shape."""

import torch

from repro_torch.models.common import LayerSpec, ModelConfig

ARCH_ID = "whisper-tiny"
ENCODER_FRAMES = 1500


def config(dtype=torch.bfloat16) -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        pattern=(LayerSpec("attn", "mlp"),),
        act="gelu",
        encoder_layers=4,
        encoder_frames=ENCODER_FRAMES,
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
        d_ff=96,
        vocab_size=128,
        pattern=(LayerSpec("attn", "mlp"),),
        act="gelu",
        encoder_layers=2,
        encoder_frames=16,
        dtype=dtype,
    )

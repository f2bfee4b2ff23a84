"""Assigned input shapes (same 4 for every LM arch) and per-cell
applicability (DESIGN.md §Shape-cell skips)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs with a sub-quadratic / bounded-state long-context path
LONG_CONTEXT_OK = {
    "xlstm-1.3b",        # recurrent state
    "jamba-v0.1-52b",    # mamba state + few attn layers (KV seq-sharded)
    "mixtral-8x22b",     # SWA -> windowed ring KV
    "gemma3-27b",        # 5:1 local:global (local windowed, global seq-sharded)
}

PURE_FULL_ATTENTION_SKIPS = {
    "deepseek-moe-16b",
    "starcoder2-15b",
    "starcoder2-7b",
    "phi3-mini-3.8b",
    "llava-next-mistral-7b",
    "whisper-tiny",      # enc-dec full attention; arch context is 448 anyway
}


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    """(supported, reason_if_not)."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, "long_500k skipped: pure full-attention arch (DESIGN.md §Shape-cell skips)"
    return True, ""

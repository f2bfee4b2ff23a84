"""Deterministic, stateless-resumable synthetic LM data. Counterpart of
`repro.data.pipeline`.

A batch is a pure function of ``(seed, step)``: a restart from a
checkpoint needs no iterator state, and shards of any count tile the same
global batch. The tokens follow the reference's second-order recurrence
``x_{t+1} = (a*x_t + b*x_{t-1} + 1 + noise) % V``, with ``(a, b)`` from the
seed and noise 1 at 5% of positions, which a model can learn down to the
noise floor.

The random draws (the two starting tokens of each row and the noise) come
from a CPU `torch.Generator` seeded from ``(seed, step)``, so a batch is the
same on any machine and whatever device it is then moved to. They are not
`jax.random`'s numbers: the two packages' batches differ, their structure
does not.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["DataConfig", "DataIterator", "global_batch_at", "shard_batch_at"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0


NOISE_RATE = 0.05


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for ``(seed, step)``: a 64-bit mix of the two, so
    that nearby pairs give unrelated streams."""
    mixed = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + 0x94D049BB133111EB) % (1 << 63)
    return torch.Generator().manual_seed(mixed)


def _synth_tokens(gen: torch.Generator, batch: int, seq: int, vocab: int, seed: int) -> torch.Tensor:
    """(batch, seq) int32 tokens of the recurrence with dataset-global
    ``a = seed % 5 + 2``, ``b = (seed // 5) % 3`` (the reference's)."""
    a = seed % 5 + 2
    b = (seed // 5) % 3
    x0 = torch.randint(0, vocab, (batch, 2), generator=gen, dtype=torch.int64).numpy()
    noise = (torch.rand((batch, seq), generator=gen) < NOISE_RATE).numpy().astype(np.int64)
    toks = np.empty((batch, seq), dtype=np.int64)
    x_prev2, x_prev1 = x0[:, 0], x0[:, 1]
    for t in range(seq):
        nxt = (a * x_prev1 + b * x_prev2 + noise[:, t] + 1) % vocab
        toks[:, t] = nxt
        x_prev2, x_prev1 = x_prev1, nxt
    return torch.from_numpy(toks.astype(np.int32))


def global_batch_at(step: int, cfg: DataConfig, *, device=None) -> dict:
    """The full (global_batch, seq_len) ``inputs`` and ``targets`` of a
    step (one token block of ``seq_len + 1``, shifted), on ``device``
    (default ``cuda``, which must exist)."""
    device = resolve_device(device)
    toks = _synth_tokens(_generator(cfg.seed, step), cfg.global_batch, cfg.seq_len + 1, cfg.vocab_size, cfg.seed)
    return {"inputs": toks[:, :-1].to(device), "targets": toks[:, 1:].to(device)}


def shard_batch_at(step: int, cfg: DataConfig, shard: int, n_shards: int, *, device=None) -> dict:
    """Shard ``shard`` of ``n_shards`` of the step's global batch (rows in
    order: elastic re-sharding keeps the global batch)."""
    if cfg.global_batch % n_shards:
        raise ValueError(f"global batch {cfg.global_batch} does not split into {n_shards} shards")
    per = cfg.global_batch // n_shards
    full = global_batch_at(step, cfg, device=device)
    return {k: v[shard * per:(shard + 1) * per] for k, v in full.items()}


class DataIterator:
    """Thin stateful convenience over the stateless functions."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, *, device=None):
        self.cfg = cfg
        self.step = start_step
        self.device = device

    def __next__(self) -> dict:
        batch = global_batch_at(self.step, self.cfg, device=self.device)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step}

    @classmethod
    def restore(cls, cfg: DataConfig, state: dict, *, device=None) -> "DataIterator":
        return cls(cfg, start_step=state["step"], device=device)

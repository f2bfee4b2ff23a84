"""The port's synthetic LM data pipeline (`repro_torch.data`), the
counterpart of the data checks of tests/test_training.py.

The port draws its tokens from a CPU `torch.Generator` seeded from (seed,
step), not from `jax.random`, so its batches are held to their own
numbers: the same batch for the same step, shards that tile the global
batch, steps that differ, the reference's recurrence exactly (with its
dataset-global a, b and noise in {0, 1} at 5% +- 1% of positions), and the
same batch on whatever device is asked for. This file imports no JAX: its
card test runs on the chip's machine too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import DataConfig, DataIterator, global_batch_at, shard_batch_at  # noqa: E402

DATA = DataConfig(vocab_size=64, global_batch=8, seq_len=32, seed=0)


def _tokens(batch) -> np.ndarray:
    """The step's token block (B, S + 1) from its inputs and targets."""
    inputs, targets = batch["inputs"].cpu().numpy(), batch["targets"].cpu().numpy()
    np.testing.assert_array_equal(inputs[:, 1:], targets[:, :-1])
    return np.concatenate([inputs, targets[:, -1:]], axis=1)


def test_data_pipeline_deterministic_and_elastic():
    b1 = global_batch_at(3, DATA, device="cpu")
    b2 = global_batch_at(3, DATA, device="cpu")
    assert b1["inputs"].dtype == torch.int32 and b1["inputs"].shape == (8, 32)
    for k in ("inputs", "targets"):
        assert torch.equal(b1[k], b2[k])
    # elastic: 2 shards and 4 shards tile the same global batch
    for n in (2, 4):
        shards = [shard_batch_at(3, DATA, i, n, device="cpu") for i in range(n)]
        for k in ("inputs", "targets"):
            assert torch.equal(torch.cat([s[k] for s in shards]), b1[k])
    with pytest.raises(ValueError):
        shard_batch_at(3, DATA, 0, 3, device="cpu")
    # the iterator walks the same steps and restores from its state
    it = DataIterator(DATA, start_step=2, device="cpu")
    next(it)
    assert torch.equal(next(it)["inputs"], b1["inputs"])
    again = DataIterator.restore(DATA, {"step": 3}, device="cpu")
    assert torch.equal(next(again)["targets"], b1["targets"])


def test_data_steps_and_seeds_differ():
    b3 = global_batch_at(3, DATA, device="cpu")["inputs"]
    assert not torch.equal(b3, global_batch_at(4, DATA, device="cpu")["inputs"])
    other = DataConfig(vocab_size=64, global_batch=8, seq_len=32, seed=1)
    assert not torch.equal(b3, global_batch_at(3, other, device="cpu")["inputs"])


@pytest.mark.parametrize("seed", [0, 7, 13])
def test_recurrence_holds_exactly_with_five_percent_noise(seed):
    """x_{t+1} = (a x_t + b x_{t-1} + 1 + noise) % V with the reference's
    a = seed % 5 + 2, b = (seed // 5) % 3 and noise in {0, 1}, set at 5% +-
    1% of the positions (64 x 512 of them)."""
    cfg = DataConfig(vocab_size=1000, global_batch=64, seq_len=512, seed=seed)
    toks = _tokens(global_batch_at(5, cfg, device="cpu")).astype(np.int64)
    a, b = seed % 5 + 2, (seed // 5) % 3
    noise = (toks[:, 2:] - a * toks[:, 1:-1] - b * toks[:, :-2] - 1) % cfg.vocab_size
    assert set(np.unique(noise)) <= {0, 1}
    share = noise.mean()
    assert 0.04 <= share <= 0.06, share
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size


def test_batch_is_made_on_the_host_then_moved():
    """The tokens do not depend on the device asked for: the batch is drawn
    on the host, and the same numbers land on any device (here a ``meta``
    device, which holds the shape alone)."""
    cpu = global_batch_at(6, DATA, device="cpu")
    meta = global_batch_at(6, DATA, device="meta")
    assert meta["inputs"].device.type == "meta"
    assert meta["inputs"].shape == cpu["inputs"].shape and meta["inputs"].dtype == cpu["inputs"].dtype
    assert torch.equal(cpu["inputs"], global_batch_at(6, DATA, device=torch.device("cpu"))["inputs"])


@pytest.mark.gpu
def test_batch_on_the_card_equals_the_host_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cpu = global_batch_at(9, DATA, device="cpu")
    card = global_batch_at(9, DATA, device="cuda")
    for k in cpu:
        assert card[k].device.type == "cuda"
        assert torch.equal(card[k].cpu(), cpu[k])

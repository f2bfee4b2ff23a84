"""The synthetic LM data pipeline. Counterpart of `repro.data`."""

from repro_torch.data.pipeline import DataConfig, DataIterator, global_batch_at, shard_batch_at  # noqa: F401

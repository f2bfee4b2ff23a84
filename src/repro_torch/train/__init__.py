"""The LM train step. Counterpart of `repro.train`."""

from repro_torch.train.step import TrainConfig, init_train_state, make_train_step  # noqa: F401

"""Optimizers on PyTorch: counterpart of `repro.optim`."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    ScheduleConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    lr_schedule,
)

"""Differentiable simulation on PyTorch: counterpart of `repro.grad`.

Three layers over the single-device window:

* `grad.permutations` — `torch.autograd.Function`s that treat the sorter's
  index machinery as piecewise-constant permutations (indices carry no
  gradient, value movement is differentiable). `core.binning` imports it,
  so this package's `__init__` stays import-light: everything else is
  exported lazily (PEP 562), which keeps `core.binning ->
  grad.permutations` free of import cycles.
* `grad.objectives` / `grad.params` / `grad.spec` — the registry of physics
  objectives, the SimSpec-leaf -> trainable-parameter mapping and the
  `GradSpec` that names one gradient problem.
* `grad.fit` — `make_objective` / `fit_simulation`: AdamW over one
  forward and `backward()` of objective∘`run_window_diff` an iteration.
"""

from __future__ import annotations

_LAZY = {
    "permute_values": "repro_torch.grad.permutations",
    "permute_tree": "repro_torch.grad.permutations",
    "slot_gather": "repro_torch.grad.permutations",
    "GradSpec": "repro_torch.grad.spec",
    "register_objective": "repro_torch.grad.objectives",
    "get_objective": "repro_torch.grad.objectives",
    "objective_names": "repro_torch.grad.objectives",
    "LEARNABLE": "repro_torch.grad.params",
    "resolve_param": "repro_torch.grad.params",
    "default_params": "repro_torch.grad.params",
    "StateBuilder": "repro_torch.grad.params",
    "FitResult": "repro_torch.grad.fit",
    "make_objective": "repro_torch.grad.fit",
    "fit_simulation": "repro_torch.grad.fit",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return __all__

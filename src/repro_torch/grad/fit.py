"""The optimization loop: AdamW over the gradient of objective∘window.
Counterpart of `repro.grad.fit`.

`make_objective(spec, ...)` assembles the differentiable problem — a
`StateBuilder` (eager index machinery, differentiable parameter
application), `run_window_diff` at the GradSpec's remat policy on the
``torch`` backend, and a registered objective — into one ``loss_fn(params)
-> (loss, aux)``. `fit_simulation(...)` drives it with `optim.adamw`: each
iteration is one forward and one ``backward()``, with per-iteration
checkpoints through `checkpoint.CheckpointManager` (the reference's
step-stamped store, whose files either package resumes).

The problem is set up once a fit: parameters are tensors the loss reads, so
an AdamW step changes values and nothing else (``FitResult.compiles``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.grad.objectives import get_objective
from repro_torch.grad.params import StateBuilder
from repro_torch.grad.spec import GradSpec

__all__ = ["FitResult", "fit_simulation", "make_objective"]

#: differentiable problems set up (`_problem`): a fit reads its delta
_setups = 0


@dataclasses.dataclass
class FitResult:
    """Outcome of `fit_simulation`: final params (Python floats), the
    per-iteration trajectory (each record holds the evaluated params, loss,
    physical objective, grads and grad norm), the problem description, and
    ``compiles``. The reference counts the window's traces there; the port
    has no trace, and the field keeps its meaning: how many times the
    differentiable problem (`StateBuilder` and window) was set up during
    the fit, 1 when AdamW steps changed values only."""

    params: dict
    history: list
    spec: object
    grad: GradSpec
    compiles: int

    @property
    def objective_trajectory(self) -> list:
        return [r["objective"] for r in self.history]


def _resolve(spec, grad, *, objective=None, learn=None, steps=None, remat=None, remat_chunk=None,
             objective_kwargs=None) -> GradSpec:
    """Merge keyword conveniences into a GradSpec (kwargs win)."""
    base = grad or GradSpec()
    kw = {}
    if objective is not None:
        kw["objective"] = objective
    if learn is not None:
        kw["learn"] = tuple(learn)
    if steps is not None:
        kw["steps"] = steps
    if remat is not None:
        kw["remat"] = remat
    if remat_chunk is not None:
        kw["remat_chunk"] = remat_chunk
    if objective_kwargs is not None:
        kw["objective_kwargs"] = tuple(objective_kwargs.items()) \
            if isinstance(objective_kwargs, dict) else tuple(objective_kwargs)
    return dataclasses.replace(base, **kw) if kw else base


def _problem(spec, gspec: GradSpec, dtype=None, device=None):
    """-> (loss_fn, params0, builder, n_steps). The loss is minimized:
    maximize-objectives are negated, and aux carries the physical value and
    the window's halt code and step count."""
    global _setups
    from repro_torch.api.facade import pic_config
    from repro_torch.core.resort_policy import policy_init
    from repro_torch.pic.simulation import run_window_diff

    _setups += 1
    obj = get_objective(gspec.objective)
    config = dataclasses.replace(pic_config(spec), backend="torch")
    builder = StateBuilder(spec, config, dtype=dtype, device=device)
    n_steps = gspec.steps or spec.run.steps
    chunk = 0
    if gspec.remat == "chunk":
        chunk = gspec.remat_chunk or spec.run.window or 0
        if chunk <= 0 or n_steps % chunk:
            raise ValueError(
                f"remat='chunk' needs a positive chunk dividing the {n_steps} differentiated steps; got {chunk} "
                "(set GradSpec.remat_chunk or spec.run.window)"
            )
    okw = gspec.okwargs

    def loss_fn(params):
        state = builder.build(params)
        fstate, _, bundle = run_window_diff(
            state, policy_init(builder.device), builder.config, n_steps, policy=spec.sort.policy,
            with_energies=False, remat=gspec.remat, remat_chunk=chunk,
        )
        value = obj.fn(fstate, bundle, builder.config, **okw)
        loss = -value if obj.maximize else value
        aux = {"objective": value, "halt_code": bundle["halt_code"], "n_done": bundle["n_done"]}
        return loss, aux

    return loss_fn, builder.initial_params(gspec.learn), builder, n_steps


def make_objective(spec, grad: GradSpec | None = None, *, dtype=None, device=None, **kw):
    """Build the differentiable problem a spec and GradSpec describe, on
    ``device`` (default ``cuda``).

    Returns ``(loss_fn, params0)``: ``loss_fn(params) -> (loss, aux)``
    (``aux``: objective value, halt_code, n_done); give it params that
    require grad and call ``loss.backward()``. ``params0`` are the spec's
    current values of the learned leaves. Keyword conveniences
    (``objective=``, ``learn=``, ``steps=``, ``remat=``, ...) override the
    GradSpec; ``dtype=torch.float64`` runs the whole problem in double
    precision for finite-difference checks.
    """
    gspec = _resolve(spec, grad, **kw)
    loss_fn, params0, _, _ = _problem(spec, gspec, dtype=dtype, device=device)
    return loss_fn, params0


def fit_simulation(spec, grad: GradSpec | None = None, *, iters: int = 8, optimizer=None,
                   checkpoint_dir: str | None = None, checkpoint_every: int = 1, keep: int = 2,
                   on_iteration=None, dtype=None, device=None, **kw) -> FitResult:
    """Optimize the learned SimSpec leaves with AdamW (`optim.adamw`), on
    ``device`` (default ``cuda``).

    Each of ``iters`` iterations is one forward and one ``backward()``; a
    window halt (capacity overflow) and a non-finite loss or gradient raise
    rather than poison the trajectory. ``checkpoint_dir`` saves {params,
    optimizer state} every ``checkpoint_every`` iterations (atomic writes,
    keep-``keep`` garbage collection) and resumes from the latest one when
    present: re-running the same call after a crash continues the fit.
    ``on_iteration(record)`` sees each appended history record.
    """
    from repro_torch.core.health import HALT_NAMES
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    gspec = _resolve(spec, grad, **kw)
    setups0 = _setups
    loss_fn, params, _, _ = _problem(spec, gspec, dtype=dtype, device=device)
    cfg = optimizer or AdamWConfig(lr=0.05, weight_decay=0.0)
    opt = adamw_init(params)
    start = 0
    manager = None
    if checkpoint_dir:
        from repro_torch.checkpoint import CheckpointManager

        manager = CheckpointManager(checkpoint_dir, keep=keep)
        latest = manager.latest_step()
        if latest is not None:
            restored, _ = manager.restore({"params": params, "opt": opt}, latest)
            params, opt = restored["params"], restored["opt"]
            start = latest

    history = []
    for it in range(start, iters):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, aux = loss_fn(leaves)
        halt = int(aux["halt_code"])
        if halt:
            raise RuntimeError(
                f"fit iteration {it}: window halted with code {halt} ({HALT_NAMES[halt]}) after "
                f"{int(aux['n_done'])} steps — grow spec.sort.capacity (the differentiable window cannot "
                "grow mid-trace)"
            )
        loss.backward()
        grads = {k: v.grad for k, v in leaves.items()}
        record = {
            "iter": it,
            "loss": float(loss.detach()),
            "objective": float(aux["objective"].detach()),
            "params": {k: float(v) for k, v in params.items()},
            "grads": {k: float(g) for k, g in grads.items()},
        }
        if not all(math.isfinite(v) for v in [record["loss"], *record["grads"].values()]):
            raise RuntimeError(f"fit iteration {it}: non-finite loss/gradient {record}")
        params, opt, metrics = adamw_update(grads, opt, params, cfg)
        record["grad_norm"] = float(metrics["grad_norm"])
        history.append(record)
        if on_iteration is not None:
            on_iteration(record)
        if manager is not None and (it + 1) % checkpoint_every == 0:
            manager.save(it + 1, {"params": params, "opt": opt})
    return FitResult(
        params={k: float(v) for k, v in params.items()},
        history=history,
        spec=spec,
        grad=gspec,
        compiles=_setups - setups0,
    )

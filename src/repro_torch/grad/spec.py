"""`GradSpec`: the declarative description of one gradient problem.
Counterpart of `repro.grad.spec`, with the same JSON.

The forward physics lives in a `SimSpec`; a `GradSpec` adds what the
gradient subsystem needs on top — which registered objective to optimize,
which SimSpec leaves are trainable (`grad.params.LEARNABLE`), how many
steps the differentiated window runs, and the recomputation policy of the
reverse pass (`torch.utils.checkpoint`). Its JSON is the reference's: a
dump of either package loads in the other.
"""

from __future__ import annotations

import dataclasses

__all__ = ["GradSpec"]

_REMAT_POLICIES = ("step", "chunk", "none")


@dataclasses.dataclass(frozen=True)
class GradSpec:
    """One gradient problem over a `SimSpec`.

    objective:        registered name (grad.objectives.objective_names()).
    learn:            trainable SimSpec leaves, canonical names or aliases
                      (``laser.a0``, ``laser.waist``/``laser.w0``,
                      ``laser.duration``/``laser.tau``, ``density``).
    steps:            differentiated window length; 0 -> the spec's
                      ``run.steps``.
    remat:            reverse-mode rematerialization granularity —
                      ``"step"`` (one checkpoint per step: the backward
                      recomputes one step at a time), ``"chunk"``
                      (per ``remat_chunk``-step sub-window), or ``"none"``
                      (store every residual).
    remat_chunk:      sub-window length for ``remat="chunk"``; 0 -> the
                      spec's ``run.window``. Must divide ``steps``.
    objective_kwargs: keyword overrides forwarded to the objective function;
                      a dict or ``((name, value), ...)`` pairs, stored frozen
                      as the latter (e.g. ``(("e_min", 0.5),)``).
    """

    objective: str = "injected_charge"
    learn: tuple = ("laser.a0",)
    steps: int = 0
    remat: str = "step"
    remat_chunk: int = 0
    objective_kwargs: tuple = ()

    def __post_init__(self):
        if self.remat not in _REMAT_POLICIES:
            raise ValueError(
                f"unknown remat policy {self.remat!r}; one of {_REMAT_POLICIES}"
            )
        if not self.learn:
            raise ValueError("GradSpec.learn must name at least one parameter")
        from repro_torch.grad.params import resolve_param

        object.__setattr__(
            self, "learn", tuple(resolve_param(p) for p in self.learn)
        )
        pairs = (
            self.objective_kwargs.items()
            if isinstance(self.objective_kwargs, dict)
            else self.objective_kwargs
        )
        object.__setattr__(
            self, "objective_kwargs", tuple((str(k), v) for k, v in pairs)
        )

    @property
    def okwargs(self) -> dict:
        return dict(self.objective_kwargs)

    def to_dict(self) -> dict:
        return {
            "objective": self.objective,
            "learn": list(self.learn),
            "steps": self.steps,
            "remat": self.remat,
            "remat_chunk": self.remat_chunk,
            "objective_kwargs": [list(kv) for kv in self.objective_kwargs],
        }

    @staticmethod
    def from_dict(d: dict) -> "GradSpec":
        kw = dict(d)
        if "learn" in kw:
            kw["learn"] = tuple(kw["learn"])
        if "objective_kwargs" in kw:
            kw["objective_kwargs"] = tuple(tuple(kv) for kv in kw["objective_kwargs"])
        return GradSpec(**kw)

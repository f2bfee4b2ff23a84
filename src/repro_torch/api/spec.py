"""Declarative simulation specification: one frozen, serializable tree that
names everything a run needs. Counterpart of `repro.api.spec`, with the same
nodes, field names, defaults and JSON: a spec that one package dumps, the
other loads (`SimSpec.from_json(s).to_dict()` gives back the dict ``s``
holds).

Kernel backends are kept under the port's names (``torch``, ``cuda``,
``cuda_reduced``) and written under the reference's (``xla``, ``pallas``,
``pallas_reduced``); ``auto`` is ``auto`` in both.

`EnsembleSpec` is N runs as one base spec and per-member flat overrides,
with the reference's JSON.

The nodes of what the port does not run yet load, and their defaults are
accepted, but a value other than the default is refused by name with
`NotImplementedError`: a device mesh and a communication option (see
`SimSpec.__post_init__`). `CommSpec` is a copy of the reference's field list
and checks; `HealthConfig` (`repro_torch.core.health`) and `FaultSpec`
(`repro_torch.distributed.fault`) are the port's own copies, as in the
reference.
"""

from __future__ import annotations

import dataclasses
import json
import math
import warnings
from typing import Any

from repro_torch.core.health import HealthConfig
from repro_torch.core.resort_policy import SortPolicyConfig
from repro_torch.distributed.fault import FaultSpec
from repro_torch.kernels import dispatch
from repro_torch.pic.grid import GridSpec
from repro_torch.pic.laser import LaserSpec

__all__ = [
    "CommSpec",
    "DepositionSpec",
    "DriftSpec",
    "EnsembleSpec",
    "FaultSpec",
    "HealthConfig",
    "MeshSpec",
    "PerturbSpec",
    "PlasmaSpec",
    "ProfileSpec",
    "RunSpec",
    "SimSpec",
    "SortSpec",
]


def _to_jsonable(obj: Any) -> Any:
    """Spec tree -> plain dicts, lists and scalars (field order kept)."""
    if isinstance(obj, _Node):
        return obj.to_dict()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _fields_dict(obj)
    if isinstance(obj, (tuple, list)):
        return [_to_jsonable(v) for v in obj]
    return obj


def _fields_dict(obj) -> dict:
    return {f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _shape3(v) -> tuple[int, int, int]:
    x, y, z = (int(s) for s in v)
    return (x, y, z)


def _dx3(v) -> tuple[float, float, float]:
    x, y, z = (float(d) for d in v)
    return (x, y, z)


def _pick(cls, d: dict) -> dict:
    """The entries of ``d`` that construct ``cls``: unknown keys raise (a
    dropped knob would change the physics), missing ones take the defaults."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__} spec has unknown keys {sorted(unknown)}")
    return {k: v for k, v in d.items() if k in names}


class _Node:
    """JSON round trip of a frozen spec node."""

    def to_dict(self) -> dict:
        return _fields_dict(self)

    def to_json(self, *, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=False)

    @classmethod
    def from_dict(cls, d: dict):
        return cls(**_pick(cls, d))

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))


# -- plasma ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProfileSpec(_Node):
    """Density profile along z. ``kind="step"``: vacuum below ``z_on`` (grid
    units), plasma at the spec density above it."""

    kind: str = "step"
    z_on: float = 0.0

    def __post_init__(self):
        if self.kind not in ("step",):
            raise ValueError(f"unknown profile kind {self.kind!r} (supported: 'step')")


@dataclasses.dataclass(frozen=True)
class DriftSpec(_Node):
    """Two symmetric counter-streaming beams at +/-``u`` along ``axis``."""

    u: float = 0.2
    axis: int = 2

    def __post_init__(self):
        if self.axis not in (0, 1, 2):
            raise ValueError(f"drift axis must be 0, 1 or 2, got {self.axis}")


@dataclasses.dataclass(frozen=True)
class PerturbSpec(_Node):
    """Velocity seed u[v_axis] += amplitude * sin(k x[k_axis]), k the
    ``mode``-th harmonic; ``k_axis=-1`` means k_axis = v_axis."""

    v_axis: int = 0
    amplitude: float = 0.01
    mode: int = 1
    k_axis: int = -1

    def __post_init__(self):
        if self.v_axis not in (0, 1, 2):
            raise ValueError(f"perturb v_axis must be 0, 1 or 2, got {self.v_axis}")
        if self.k_axis not in (-1, 0, 1, 2):
            raise ValueError(f"perturb k_axis must be -1 (=v_axis), 0, 1 or 2, got {self.k_axis}")
        if self.mode < 1:
            raise ValueError(f"perturb mode must be a positive harmonic, got {self.mode}")


@dataclasses.dataclass(frozen=True)
class PlasmaSpec(_Node):
    """Per-cell lattice placement with optional thermal spread, density
    profile, counter-streaming drift and seed perturbation."""

    ppc_each_dim: tuple[int, int, int] = (2, 2, 2)
    density: float = 1.0
    u_thermal: float = 0.0
    jitter: float = 0.0
    seed: int = 0
    profile: ProfileSpec | None = None
    drift: DriftSpec | None = None
    perturb: PerturbSpec | None = None

    def __post_init__(self):
        object.__setattr__(self, "ppc_each_dim", _shape3(self.ppc_each_dim))

    @property
    def ppc(self) -> int:
        return self.ppc_each_dim[0] * self.ppc_each_dim[1] * self.ppc_each_dim[2]

    @classmethod
    def from_dict(cls, d: dict) -> "PlasmaSpec":
        kw = _pick(cls, d)
        for key, sub in (("profile", ProfileSpec), ("drift", DriftSpec), ("perturb", PerturbSpec)):
            if kw.get(key) is not None:
                kw[key] = sub.from_dict(kw[key])
        return cls(**kw)


# -- numerics: deposition and gather, sorter, mesh, schedule -----------------


@dataclasses.dataclass(frozen=True)
class DepositionSpec(_Node):
    """Deposition order and mode, the gather pairing, and the kernel backend
    of the bin contractions: ``auto`` | ``torch`` | ``cuda`` |
    ``cuda_reduced``; the reference's ``xla`` | ``pallas`` |
    ``pallas_reduced`` map onto them. ``use_pallas`` is the reference's
    deprecated boolean: it maps to ``cuda``/``torch`` with a
    DeprecationWarning and is normalised away (None after construction)."""

    order: int = 1
    mode: str = "matrix"  # matrix (fused) | matrix_unfused | scatter | rhocell
    backend: str = "auto"
    use_pallas: bool | None = None  # deprecated: backend="cuda"/"torch"
    gather: str = ""      # "" (auto) | matrix (fused) | matrix_unfused | scatter

    def __post_init__(self):
        if self.use_pallas is not None:
            warnings.warn("DepositionSpec.use_pallas is deprecated; use backend='cuda' / backend='torch' instead",
                          DeprecationWarning, stacklevel=3)
            object.__setattr__(self, "backend", "cuda" if self.use_pallas else "torch")
            object.__setattr__(self, "use_pallas", None)
        if self.mode not in ("matrix", "matrix_unfused", "scatter", "rhocell"):
            raise ValueError(f"unknown deposition mode {self.mode!r}")
        if self.gather not in ("", "matrix", "matrix_unfused", "scatter"):
            raise ValueError(f"unknown gather mode {self.gather!r}")
        if self.order not in (1, 2, 3):
            raise ValueError(f"deposition order must be 1, 2 or 3, got {self.order}")
        object.__setattr__(self, "backend", dispatch.canonical(self.backend))

    @property
    def resolved_gather(self) -> str:
        """The gather mode; by default the fused matrix gather beside a
        matrix deposition, the scatter gather beside the others."""
        if self.gather:
            return self.gather
        return "matrix" if self.mode in ("matrix", "matrix_unfused") else "scatter"

    def to_dict(self) -> dict:
        return dict(_fields_dict(self), backend=dispatch.reference_name(self.backend))


@dataclasses.dataclass(frozen=True)
class SortSpec(_Node):
    """GPMA sorter mode, bin capacity and the adaptive re-sort policy.
    ``capacity=0`` auto-sizes to ``max(16, 4 * ppc)``."""

    mode: str = "incremental"  # incremental | rebuild | global | none
    capacity: int = 0
    policy: SortPolicyConfig = SortPolicyConfig()

    def __post_init__(self):
        if self.mode not in ("incremental", "rebuild", "global", "none"):
            raise ValueError(f"unknown sort mode {self.mode!r}")

    def resolved_capacity(self, ppc: int) -> int:
        return self.capacity if self.capacity > 0 else max(16, 4 * ppc)

    @classmethod
    def from_dict(cls, d: dict) -> "SortSpec":
        kw = _pick(cls, d)
        if "policy" in kw:
            kw["policy"] = SortPolicyConfig(**_pick(SortPolicyConfig, kw["policy"]))
        return cls(**kw)


def _parse_mesh(text: str) -> tuple[int, int]:
    """An SXxSY mesh ('4x2')."""
    try:
        sx, sy = (int(v) for v in text.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"a mesh is SXxSY (e.g. 4x2), got {text!r}") from e
    return sx, sy


@dataclasses.dataclass(frozen=True)
class MeshSpec(_Node):
    """Device mesh: ``shape=None`` is the single-device driver; an
    ``(sx, sy)`` shape (or ``"SXxSY"``) the distributed one, which the port
    does not run yet."""

    shape: tuple[int, int] | None = None
    mig_cap: int = 256
    n_local: int = 0

    def __post_init__(self):
        shape = self.shape
        if isinstance(shape, str):
            shape = _parse_mesh(shape)
        elif shape is not None:
            sx, sy = (int(v) for v in shape)
            shape = (sx, sy)
        if shape is not None and (shape[0] < 1 or shape[1] < 1):
            raise ValueError(f"mesh sizes must be positive, got {shape}")
        object.__setattr__(self, "shape", shape)

    @property
    def n_devices(self) -> int:
        return 1 if self.shape is None else self.shape[0] * self.shape[1]


@dataclasses.dataclass(frozen=True)
class CommSpec(_Node):
    """Communication options of the distributed driver (the reference's
    `repro.distributed.comm.CommSpec` fields)."""

    overlap_halo: bool = False
    compress_migration: bool = False
    rebalance_enable: bool = False
    imbalance_ratio: float = 4.0

    def __post_init__(self):
        if self.imbalance_ratio <= 1.0:
            raise ValueError(f"CommSpec.imbalance_ratio must exceed 1.0 (perfect balance), got {self.imbalance_ratio}")


@dataclasses.dataclass(frozen=True)
class RunSpec(_Node):
    """Run schedule: default step count, window length (``window=0`` selects
    the host-driven per-step loop), diagnostics cadence, timestep (``dt=0``
    derives the Courant limit at ``cfl_safety``), and autosave."""

    steps: int = 50
    window: int = 16
    diagnostics_every: int = 0
    dt: float = 0.0
    cfl_safety: float = 0.5
    autosave_every: int = 0
    autosave_path: str = ""

    def __post_init__(self):
        if self.autosave_every < 0:
            raise ValueError(f"autosave_every must be >= 0, got {self.autosave_every}")


# -- the root ------------------------------------------------------------------


def _not_ported(field: str, value, what: str):
    return NotImplementedError(f"SimSpec.{field}={value!r}: {what} is not ported to repro_torch yet "
                               "(ROADMAP, queue A); only the default runs")


@dataclasses.dataclass(frozen=True)
class SimSpec(_Node):
    """The whole run, declaratively; build via the scenario registry
    (`repro_torch.api.scenario`) or `from_json`, run via `make_simulation`."""

    name: str
    grid: GridSpec
    plasma: PlasmaSpec = PlasmaSpec()
    laser: LaserSpec | None = None
    deposition: DepositionSpec = DepositionSpec()
    sort: SortSpec = SortSpec()
    mesh: MeshSpec = MeshSpec()
    comm: CommSpec = CommSpec()
    run: RunSpec = RunSpec()
    health: HealthConfig = HealthConfig()
    fault: FaultSpec | None = None
    charge: float = -1.0
    mass: float = 1.0
    ckc_beta: float = 0.0

    def __post_init__(self):
        if not isinstance(self.grid, GridSpec):
            raise TypeError(f"SimSpec.grid must be a GridSpec, got {type(self.grid).__name__}")
        if self.mesh.shape is not None:
            raise _not_ported("mesh.shape", self.mesh.shape, "the distributed driver")
        if self.comm != CommSpec():
            raise _not_ported("comm", self.comm, "the distributed driver's communication")
        if self.fault is not None and self.fault.kind == "recv_drop" and self.mesh.shape is None:
            raise ValueError("fault kind 'recv_drop' targets the distributed migration path — "
                             "single-device runs have no recv buffer to drop from")

    @property
    def dt(self) -> float:
        """The resolved timestep (explicit, or the Courant limit)."""
        return self.run.dt if self.run.dt > 0 else self.grid.cfl_dt(self.run.cfl_safety)

    @property
    def omega_p(self) -> float:
        """Plasma frequency of the spec density (normalized units)."""
        return math.sqrt(self.plasma.density)

    @classmethod
    def from_dict(cls, d: dict) -> "SimSpec":
        kw = _pick(cls, dict(d))
        if "grid" not in kw:
            raise ValueError("SimSpec requires a 'grid' entry")
        g = kw["grid"]
        kw["grid"] = GridSpec(shape=_shape3(g["shape"]), dx=_dx3(g.get("dx", (1.0, 1.0, 1.0))))
        if kw.get("laser") is not None:
            kw["laser"] = LaserSpec(**_pick(LaserSpec, kw["laser"]))
        for key, sub in (
            ("plasma", PlasmaSpec), ("deposition", DepositionSpec), ("sort", SortSpec),
            ("mesh", MeshSpec), ("comm", CommSpec), ("run", RunSpec), ("health", HealthConfig),
        ):
            if key in kw:
                kw[key] = sub.from_dict(kw[key])
        if kw.get("fault") is not None:
            kw["fault"] = FaultSpec.from_dict(kw["fault"])
        return cls(**kw)


# -- ensembles: one base spec and per-member flat overrides ------------------


_SINGLE_DEVICE = "the ensemble engine is single-device"


@dataclasses.dataclass(frozen=True)
class EnsembleSpec:
    """N simulations as one base `SimSpec` and per-member flat overrides
    (the registry's `apply_overrides` names: ``seed=3``, ``density=0.5``,
    ``order=2``, ...), one dict per member; no overrides is one member equal
    to the base. Members whose overrides keep the compiled shape
    (`repro_torch.api.spec_signature`) share one bucket
    (`repro_torch.api.make_ensemble`).

    Build with `replicate` (seed-staggered copies) or `sweep` (a cartesian
    product of values), or pass the dicts. Not hashable (the overrides are
    dicts)."""

    base: SimSpec
    overrides: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "overrides", tuple(dict(o) for o in self.overrides))

    @property
    def n_members(self) -> int:
        return max(1, len(self.overrides))

    def members(self) -> list[SimSpec]:
        """The per-member specs: the base with each member's overrides, named
        ``<base>-m<i>`` unless an override names it."""
        from repro_torch.api.registry import apply_overrides  # the registry imports this module

        out = []
        for i, ov in enumerate(self.overrides or ({},)):
            ov = dict(ov)
            if ov.get("mesh") is not None:
                raise ValueError(f"ensemble member {i} overrides mesh={ov['mesh']}; {_SINGLE_DEVICE}")
            ov.setdefault("name", f"{self.base.name}-m{i}")
            out.append(apply_overrides(self.base, **ov))
        return out

    @staticmethod
    def replicate(base: SimSpec, n: int, *, seed_stride: int = 1) -> "EnsembleSpec":
        """``n`` copies of ``base`` with staggered plasma seeds: the same
        physics from independent initial conditions, one bucket."""
        if n < 1:
            raise ValueError(f"ensemble size must be >= 1, got {n}")
        seed0 = base.plasma.seed
        return EnsembleSpec(base=base, overrides=tuple({"seed": seed0 + i * seed_stride} for i in range(n)))

    @staticmethod
    def sweep(base: SimSpec, axes: dict, *, replicas: int = 1, seed_stride: int = 1) -> "EnsembleSpec":
        """The cartesian product over ``axes`` ({override name: [values]}),
        each point with ``replicas`` seed-staggered copies."""
        import itertools

        names = list(axes)
        seed0 = base.plasma.seed
        overrides = []
        for combo in itertools.product(*(axes[k] for k in names)):
            point = dict(zip(names, combo))
            for r in range(max(1, replicas)):
                ov = dict(point)
                if replicas > 1 and "seed" not in ov:
                    ov["seed"] = seed0 + r * seed_stride
                overrides.append(ov)
        return EnsembleSpec(base=base, overrides=tuple(overrides))

    def to_dict(self) -> dict:
        return {"base": self.base.to_dict(),
                "overrides": [{k: _to_jsonable(v) for k, v in ov.items()} for ov in self.overrides]}

    def to_json(self, *, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=False)

    @staticmethod
    def from_dict(d: dict) -> "EnsembleSpec":
        kw = _pick(EnsembleSpec, dict(d))
        if "base" not in kw:
            raise ValueError("EnsembleSpec requires a 'base' entry")
        if (kw["base"].get("mesh") or {}).get("shape") is not None:
            raise ValueError(f"{_SINGLE_DEVICE}: the base spec must have mesh.shape=None, got "
                             f"{kw['base']['mesh']['shape']}")
        kw["base"] = SimSpec.from_dict(kw["base"])
        kw["overrides"] = tuple(dict(o) for o in kw.get("overrides", ()))
        return EnsembleSpec(**kw)

    @staticmethod
    def from_json(s: str) -> "EnsembleSpec":
        return EnsembleSpec.from_dict(json.loads(s))

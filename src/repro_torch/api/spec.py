"""Declarative simulation specification, trimmed to the single-device
driver. Counterpart of `repro.api.spec`: the same frozen dataclasses and
field names for the parts this port runs (grid, plasma with profile, drift
and perturbation, laser, deposition with every mode, sort, run). The mesh, communication,
health and fault nodes, ensembles and the JSON round trip wait for later
slices.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.resort_policy import SortPolicyConfig
from repro_torch.kernels import dispatch
from repro_torch.pic.grid import GridSpec
from repro_torch.pic.laser import LaserSpec

__all__ = [
    "DepositionSpec",
    "DriftSpec",
    "PerturbSpec",
    "PlasmaSpec",
    "ProfileSpec",
    "RunSpec",
    "SimSpec",
    "SortSpec",
]


def _shape3(v) -> tuple[int, int, int]:
    x, y, z = (int(s) for s in v)
    return (x, y, z)


@dataclasses.dataclass(frozen=True)
class ProfileSpec:
    """Density profile along z. ``kind="step"``: vacuum below ``z_on`` (grid
    units), plasma at the spec density above it."""

    kind: str = "step"
    z_on: float = 0.0

    def __post_init__(self):
        if self.kind not in ("step",):
            raise ValueError(f"unknown profile kind {self.kind!r} (supported: 'step')")


@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """Two symmetric counter-streaming beams at +/-``u`` along ``axis``."""

    u: float = 0.2
    axis: int = 2

    def __post_init__(self):
        if self.axis not in (0, 1, 2):
            raise ValueError(f"drift axis must be 0, 1 or 2, got {self.axis}")


@dataclasses.dataclass(frozen=True)
class PerturbSpec:
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
class PlasmaSpec:
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


@dataclasses.dataclass(frozen=True)
class DepositionSpec:
    """Deposition order and mode, the gather pairing, and the kernel backend
    of the bin contractions: ``auto`` | ``torch`` | ``cuda`` |
    ``cuda_reduced``; the reference's ``xla`` | ``pallas`` |
    ``pallas_reduced`` map onto them."""

    order: int = 1
    mode: str = "matrix"  # matrix (fused) | matrix_unfused | scatter | rhocell
    backend: str = "auto"
    gather: str = ""      # "" (auto) | matrix (fused) | matrix_unfused | scatter

    def __post_init__(self):
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


@dataclasses.dataclass(frozen=True)
class SortSpec:
    """GPMA sorter mode, bin capacity and the adaptive re-sort policy.
    ``capacity=0`` auto-sizes to ``max(16, 4 * ppc)``."""

    mode: str = "incremental"
    capacity: int = 0
    policy: SortPolicyConfig = SortPolicyConfig()

    def __post_init__(self):
        if self.mode != "incremental":
            raise NotImplementedError(f"sort mode {self.mode!r} is not ported (only 'incremental')")

    def resolved_capacity(self, ppc: int) -> int:
        return self.capacity if self.capacity > 0 else max(16, 4 * ppc)


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Run schedule: default step count, window length, diagnostics cadence,
    timestep (``dt=0`` derives the Courant limit at ``cfl_safety``)."""

    steps: int = 50
    window: int = 16
    diagnostics_every: int = 0
    dt: float = 0.0
    cfl_safety: float = 0.5


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """The whole run, declaratively; build via the scenario registry
    (`repro_torch.api.scenario`), run via `make_simulation`."""

    name: str
    grid: GridSpec
    plasma: PlasmaSpec = PlasmaSpec()
    laser: LaserSpec | None = None
    deposition: DepositionSpec = DepositionSpec()
    sort: SortSpec = SortSpec()
    run: RunSpec = RunSpec()
    charge: float = -1.0
    mass: float = 1.0
    ckc_beta: float = 0.0

    def __post_init__(self):
        if not isinstance(self.grid, GridSpec):
            raise TypeError(f"SimSpec.grid must be a GridSpec, got {type(self.grid).__name__}")

    @property
    def dt(self) -> float:
        """The resolved timestep (explicit, or the Courant limit)."""
        return self.run.dt if self.run.dt > 0 else self.grid.cfl_dt(self.run.cfl_safety)

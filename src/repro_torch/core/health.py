"""The health sentinel: per-step checks on the device that turn silent
corruption into a structured window halt. Counterpart of
`repro.core.health`.

The windowed driver already halts on a bin overflow and grows the capacity.
The sentinel extends the same halt protocol to

* non-finite fields or momenta -> ``HALT_NONFINITE``;
* a charge-conservation or total-energy-drift violation against the values
  taken at window entry -> ``HALT_INVARIANT``.

The checks only read the state, so a run with the sentinel on and no fault
is bit-equal to the same run with it off. On a health halt the supervisor
(`repro_torch.distributed.fault.run_supervised_windows`) restores the
window's entry snapshot and retries under its remedy ladder.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "HALT_BIN_OVERFLOW",
    "HALT_IMBALANCE",
    "HALT_INVARIANT",
    "HALT_MIG_RECV",
    "HALT_MIG_SEND",
    "HALT_NAMES",
    "HALT_NONE",
    "HALT_NONFINITE",
    "HealthConfig",
    "INVARIANT_NAMES",
    "SimulationHealthError",
    "classify_health",
    "nonfinite_count",
]

# Window halt codes, the reference's family: 0-3 the drivers' own, 4-5 the
# sentinel's, 6 the distributed driver's repartitioning request.
HALT_NONE = 0
HALT_BIN_OVERFLOW = 1
HALT_MIG_SEND = 2
HALT_MIG_RECV = 3
HALT_NONFINITE = 4
HALT_INVARIANT = 5
HALT_IMBALANCE = 6
HALT_NAMES = (
    "none", "bin_overflow", "mig_send_overflow", "mig_recv_dropped",
    "nonfinite", "invariant", "imbalance",
)

# which check fired
INV_NONE = 0
INV_FIELDS = 1
INV_MOMENTA = 2
INV_CHARGE = 3
INV_ENERGY = 4
INVARIANT_NAMES = (
    "none", "fields_nonfinite", "momenta_nonfinite",
    "charge_conservation", "energy_drift",
)


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """The sentinel's configuration (the reference's fields and checks).

    ``charge_rtol`` bounds the step's total charge (the sum of the alive
    weights) against its window-entry value; ``energy_rtol`` and
    ``energy_atol`` bound the drift of the total energy (field + kinetic)
    over a window. ``max_retries`` bounds the remedy ladder (halve the
    window, force a global sort, demote the kernel backend) before the
    supervisor gives up; ``max_restarts`` bounds crash-and-restore cycles.
    """

    enable: bool = False
    check_nonfinite: bool = True
    check_charge: bool = True
    check_energy: bool = True
    charge_rtol: float = 1e-4
    energy_rtol: float = 0.25
    energy_atol: float = 1e-3
    max_retries: int = 3
    max_restarts: int = 3

    def __post_init__(self):
        if self.charge_rtol <= 0 or self.energy_rtol <= 0:
            raise ValueError("health tolerances must be positive")
        if self.max_retries < 1 or self.max_restarts < 0:
            raise ValueError("max_retries must be >= 1 and max_restarts >= 0")

    @staticmethod
    def from_dict(d: dict) -> "HealthConfig":
        names = {f.name for f in dataclasses.fields(HealthConfig)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"HealthConfig spec has unknown keys {sorted(unknown)}")
        return HealthConfig(**d)


class SimulationHealthError(RuntimeError):
    """Raised by the supervisor when the remedy ladder is exhausted; carries
    the last failed attempt's halt name, absolute step, invariant, and the
    measured and reference values it compared."""

    def __init__(self, *, halt: str, step: int, invariant: str, measured: float, reference: float, retries: int):
        self.halt = halt
        self.step = step
        self.invariant = invariant
        self.measured = measured
        self.reference = reference
        self.retries = retries
        super().__init__(
            f"health halt {halt!r} at step {step} persisted through {retries} "
            f"remediation attempt(s): invariant {invariant!r} measured "
            f"{measured!r} against reference {reference!r}"
        )


def nonfinite_count(tensors, mask=None) -> torch.Tensor:
    """int32 count of the non-finite entries of float tensors. ``mask``: a
    per-row validity (a dead particle's row may hold anything)."""
    total = None
    for a in tensors:
        bad = ~torch.isfinite(a)
        if mask is not None:
            bad = bad & mask.reshape(mask.shape + (1,) * (bad.dim() - mask.dim()))
        n = torch.sum(bad, dtype=torch.int32)
        total = n if total is None else total + n
    return total


def classify_health(cfg: HealthConfig, *, fields_nonfinite, momenta_nonfinite, charge, charge_ref, energy,
                    energy_ref):
    """Fold one step's measurements, 0-d tensors on one device, into one
    halt classification: 0-d tensors ``(code, invariant, measured,
    reference)``, int32, int32, float32, float32; ``code == HALT_NONE``
    means healthy. Constants are made on the device (no host copy), so the
    classification can be captured in a CUDA graph.

    Later checks outrank earlier ones: energy, then charge, then non-finite
    momenta, then non-finite fields. The comparisons take the form
    ``~(drift <= tol)``, so a NaN drift is a violation even with the
    non-finite scan off."""
    dev = charge.device
    i32 = lambda v: torch.full((), v, dtype=torch.int32, device=dev)
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=dev)
    code, inv, meas, ref = i32(HALT_NONE), i32(INV_NONE), f32(0.0), f32(0.0)
    checks = []
    if cfg.check_energy:
        e, e0 = energy.to(torch.float32), energy_ref.to(torch.float32)
        scale = torch.maximum(torch.abs(e0), f32(cfg.energy_atol))
        checks.append((~(torch.abs(e - e0) <= f32(cfg.energy_rtol) * scale), HALT_INVARIANT, INV_ENERGY, e, e0))
    if cfg.check_charge:
        q, q0 = charge.to(torch.float32), charge_ref.to(torch.float32)
        scale = torch.maximum(torch.abs(q0), f32(1e-8))
        checks.append((~(torch.abs(q - q0) <= f32(cfg.charge_rtol) * scale), HALT_INVARIANT, INV_CHARGE, q, q0))
    if cfg.check_nonfinite:
        checks.append((momenta_nonfinite > 0, HALT_NONFINITE, INV_MOMENTA, momenta_nonfinite.to(torch.float32),
                       f32(0.0)))
        checks.append((fields_nonfinite > 0, HALT_NONFINITE, INV_FIELDS, fields_nonfinite.to(torch.float32),
                       f32(0.0)))
    for bad, c, iv, m, r in checks:
        code = torch.where(bad, i32(c), code)
        inv = torch.where(bad, i32(iv), inv)
        meas = torch.where(bad, m, meas)
        ref = torch.where(bad, r, ref)
    return code, inv, meas, ref

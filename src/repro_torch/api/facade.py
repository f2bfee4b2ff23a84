"""The driver facade: spec -> initial conditions -> `Simulation`, or
`DistSimulation` when the spec names a mesh (`dist_config`), and the
checkpoints (`save_simulation`, `restore_simulation`, `load_simulation`,
the autosave's `SimCheckpointer` and `clean_stale_tmp`, from
`repro_torch.checkpoint`) and `SimDriver`, the protocol every driver
`make_simulation` returns provides; ensembles: `spec_signature`, `bucket_specs`,
`make_ensemble` and its member-indexed `EnsembleRun`, and the member
checkpoints `save_ensemble_member` / `restore_ensemble_member`; the
gradient subsystem's `make_objective` and `fit_simulation`.
Counterpart of `repro.api.facade`.

Entry points run on ``cuda`` unless the caller names another device; with
no CUDA device and no device named they raise, never falling back to the
CPU.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Protocol, runtime_checkable

import torch

from repro_torch.api.spec import EnsembleSpec, SimSpec
from repro_torch.checkpoint import (
    SimCheckpointer,
    clean_stale_tmp,
    load_simulation,
    restore_ensemble_member,
    restore_simulation,
    save_ensemble_member,
    save_simulation,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.pic.grid import FieldState, GridSpec
from repro_torch.pic.laser import inject_laser
from repro_torch.pic.plasma import ParticleState, apply_counter_drift, perturb_velocity, profiled_plasma, uniform_plasma

__all__ = [
    "EnsembleRun",
    "SimCheckpointer",
    "SimDriver",
    "bucket_specs",
    "build_fields",
    "build_particles",
    "clean_stale_tmp",
    "dist_config",
    "fit_simulation",
    "load_simulation",
    "make_objective",
    "make_ensemble",
    "make_simulation",
    "pic_config",
    "resolve_device",
    "restore_ensemble_member",
    "restore_simulation",
    "save_ensemble_member",
    "save_simulation",
    "spec_signature",
]


@runtime_checkable
class SimDriver(Protocol):
    """What every driver returned by `make_simulation` provides (the
    single-device `Simulation` and the shard mesh's `DistSimulation`).
    ``state`` is the driver's device-resident state (a `PICState`, or the
    mesh's dict of stacked shard tensors); `save` and `restore` checkpoint
    it with the policy state and the host counters."""

    spec: SimSpec | None
    sorts: int
    rebuilds: int
    history: list

    def run(self, n_steps: int | None = None, *, diagnostics_every: int | None = None,
            window=...) -> None: ...
    def diagnostics(self) -> dict: ...
    @property
    def state(self): ...
    def save(self, path: str) -> None: ...
    def restore(self, path: str) -> None: ...


def build_particles(spec: SimSpec, *, device=None) -> ParticleState:
    """PlasmaSpec -> ParticleState: lattice base (uniform or profiled), then
    counter-streaming drift, then the velocity seed. Random numbers come
    from a CPU generator seeded with ``spec.plasma.seed``."""
    device = resolve_device(device)
    p = spec.plasma
    gen = torch.Generator().manual_seed(p.seed)
    if p.profile is not None:
        z_on, density = p.profile.z_on, p.density
        parts = profiled_plasma(
            gen, spec.grid, ppc_each_dim=p.ppc_each_dim,
            density_fn=lambda z: torch.where(z > z_on, density, 0.0),
            u_thermal=p.u_thermal, jitter=p.jitter, device=device,
        )
    else:
        parts = uniform_plasma(
            gen, spec.grid, ppc_each_dim=p.ppc_each_dim, density=p.density,
            u_thermal=p.u_thermal, jitter=p.jitter, device=device,
        )
    if p.drift is not None:
        parts = apply_counter_drift(parts, u_drift=p.drift.u, axis=p.drift.axis)
    if p.perturb is not None:
        pe = p.perturb
        parts = perturb_velocity(
            parts, axis=pe.v_axis, amplitude=pe.amplitude, mode=pe.mode,
            grid=spec.grid, k_axis=None if pe.k_axis < 0 else pe.k_axis,
        )
    return parts


def build_fields(spec: SimSpec, *, device=None) -> FieldState:
    """Zero fields, plus the laser pulse when the spec names one."""
    fields = FieldState.zeros(spec.grid.shape, device=resolve_device(device))
    if spec.laser is not None:
        fields = inject_laser(fields, spec.grid, spec.laser)
    return fields


def pic_config(spec: SimSpec):
    """Derive the single-device `PICConfig` from a spec."""
    from repro_torch.pic.simulation import PICConfig

    d = spec.deposition
    return PICConfig(
        grid=spec.grid,
        dt=spec.dt,
        order=d.order,
        deposition=d.mode,
        gather=d.resolved_gather,
        sort_mode=spec.sort.mode,
        charge=spec.charge,
        mass=spec.mass,
        ckc_beta=spec.ckc_beta,
        capacity=spec.sort.resolved_capacity(spec.plasma.ppc),
        backend=d.backend,
    )


def dist_config(spec: SimSpec):
    """Derive the distributed `DistConfig` (the per-shard local grid) from
    a spec with a mesh; `SimSpec.__post_init__` has checked that the grid
    divides and that the modes are bin-based."""
    from repro_torch.pic.distributed import DistConfig

    if spec.mesh.shape is None:
        raise ValueError("dist_config needs a spec with mesh.shape set")
    sx, sy = spec.mesh.shape
    gx, gy, gz = spec.grid.shape
    d = spec.deposition
    return DistConfig(
        local_grid=GridSpec(shape=(gx // sx, gy // sy, gz), dx=spec.grid.dx),
        dt=spec.dt,
        order=d.order,
        deposition=d.mode,
        gather=d.resolved_gather,
        backend=d.backend,
        charge=spec.charge,
        mass=spec.mass,
        capacity=spec.sort.resolved_capacity(spec.plasma.ppc),
        mig_cap=spec.mesh.mig_cap,
        comm=spec.comm,
    )


def _check_mesh(spec: SimSpec, mesh, device: torch.device) -> None:
    """Refuse, by name, a mesh over ranks that ``spec`` cannot run: a spec
    with no mesh or another one, more ranks than visible cards (one card a
    rank; the reference's refusal of a mesh larger than its device count),
    a rank grid that does not divide the spec's mesh."""
    from repro_torch.distributed.ranks import check_rank_grid, check_rank_request

    if spec.mesh.shape is None:
        raise ValueError(f"spec {spec.name!r} names no mesh; ranks run the distributed driver (--mesh SXxSY)")
    if tuple(mesh.shape) != tuple(spec.mesh.shape):
        raise ValueError(f"the {mesh.sx}x{mesh.sy} mesh is not the spec's {spec.mesh.shape[0]}x{spec.mesh.shape[1]}")
    if mesh.ranks is not None:
        n_cards = torch.cuda.device_count() if device.type == "cuda" else None
        check_rank_request(mesh.ranks.world, spec.mesh.shape, n_cards=n_cards)
        check_rank_grid((mesh.ranks.px, mesh.ranks.py), *spec.mesh.shape)


def make_simulation(spec: SimSpec, *, fields: FieldState | None = None,
                    particles: ParticleState | None = None, device=None, mesh=None):
    """Build the driver a spec describes, on ``device`` (default ``cuda``):
    `Simulation` for ``MeshSpec(None)``, `DistSimulation` (every shard on
    that one device) for ``MeshSpec("SXxSY")``; with ``mesh``, a `PicMesh`
    of `repro_torch.pic.distributed.make_pic_mesh` over a process group,
    each rank holds its block on its own device (`_check_mesh` refuses what
    cannot run). ``fields``/``particles`` replace the spec-built initial
    conditions and move to the device."""
    from repro_torch.pic.dist_simulation import DistSimulation
    from repro_torch.pic.simulation import Simulation

    ranks = None if mesh is None else mesh.ranks
    if ranks is not None:
        if device is not None and torch.device(device).type != ranks.device.type:
            raise ValueError(f"device {device} is not the ranks' ({ranks.device.type})")
        device = ranks.device
    device = resolve_device(device)
    if mesh is not None:
        _check_mesh(spec, mesh, device)
    fields = build_fields(spec, device=device) if fields is None else FieldState(*(f.to(device) for f in fields.all()))
    particles = build_particles(spec, device=device) if particles is None else particles.to(device)
    if spec.mesh.shape is None:
        return Simulation(fields, particles, pic_config(spec), policy=spec.sort.policy, spec=spec)
    return DistSimulation(fields, particles, dist_config(spec), mesh=mesh or spec.mesh.shape,
                          n_local=spec.mesh.n_local or None, policy=spec.sort.policy, spec=spec)


# -- the gradient subsystem (repro_torch.grad) -----------------------------------


def make_objective(spec: SimSpec, grad=None, **kw):
    """Differentiable problem from a spec: ``(loss_fn, params0)`` with
    ``loss_fn(params) -> (loss, aux)`` differentiable through the whole
    window — see `repro_torch.grad.fit.make_objective` (``grad`` is a
    `GradSpec`; keywords like ``objective=``, ``learn=``, ``steps=``,
    ``device=`` override it)."""
    from repro_torch.grad.fit import make_objective as _make_objective

    return _make_objective(spec, grad, **kw)


def fit_simulation(spec: SimSpec, grad=None, **kw):
    """AdamW-optimize the learned SimSpec leaves against a registered
    objective — see `repro_torch.grad.fit.fit_simulation`. Returns a
    `FitResult` (final params, per-iteration trajectory, set-up count)."""
    from repro_torch.grad.fit import fit_simulation as _fit_simulation

    return _fit_simulation(spec, grad, **kw)


# -- ensembles: signatures, buckets, the member-indexed facade ------------------


def spec_signature(spec: SimSpec) -> str:
    """The compiled shape of a single-device spec as 16 hex digits: specs
    with one signature run the same window (`PICConfig`, sort policy,
    window length and particle count) and share one ensemble bucket; it is
    also the service's window-cache key. The payload and its hash are the
    reference's (`repro.api.spec_signature`), the backend under its
    reference name, so one spec JSON has one signature in both packages.
    What lives in the initial conditions (seed, density, thermal spread,
    drift, perturbation, laser, profile) changes values, not shapes, and
    stays out."""
    if spec.mesh.shape is not None:
        raise ValueError(f"spec {spec.name!r} names a device mesh {spec.mesh.shape}; signatures (and the ensemble "
                         "engine) cover single-device specs")
    cfg = pic_config(spec)
    payload = {
        "grid": list(cfg.grid.shape),
        "dx": list(cfg.grid.dx),
        "dt": cfg.dt,
        "order": cfg.order,
        "deposition": cfg.deposition,
        "gather": cfg.gather,
        "sort_mode": cfg.sort_mode,
        "charge": cfg.charge,
        "mass": cfg.mass,
        "ckc_beta": cfg.ckc_beta,
        "capacity": cfg.capacity,
        "backend": dispatch.reference_name(cfg.backend),
        "policy": dataclasses.asdict(spec.sort.policy),
        "window": spec.run.window,
        "n_particles": spec.grid.n_cells * spec.plasma.ppc,
    }
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def bucket_specs(specs) -> dict[str, list[int]]:
    """Spec indices grouped by signature, in order of first appearance:
    ``{signature: [indices]}``, one bucket each."""
    buckets: dict[str, list[int]] = {}
    for i, spec in enumerate(specs):
        buckets.setdefault(spec_signature(spec), []).append(i)
    return buckets


class EnsembleRun:
    """The member-indexed facade over one or more buckets: member i of the
    `EnsembleSpec` is slot ``slot(i) = (bucket, index)``, and every accessor
    takes the global index. `run` advances the buckets one after another."""

    def __init__(self, spec: EnsembleSpec, members: list[SimSpec], sims: list, slots: list[tuple[int, int]]):
        self.spec = spec
        self.members = members
        self.sims = sims
        self._slots = slots

    @property
    def n_members(self) -> int:
        return len(self.members)

    @property
    def signatures(self) -> list[str]:
        return [spec_signature(m) for m in self.members]

    def slot(self, i: int) -> tuple[int, int]:
        """Global member index -> (bucket, slot in the bucket)."""
        return self._slots[i]

    def run(self, n_steps=None, *, diagnostics_every: int | None = None, window: int | None = None,
            on_window=None) -> None:
        for sim in self.sims:
            sim.run(n_steps, diagnostics_every=diagnostics_every, window=window, on_window=on_window)

    def diagnostics(self, i: int | None = None):
        if i is None:
            return [self.diagnostics(j) for j in range(self.n_members)]
        b, s = self._slots[i]
        return dict(self.sims[b].diagnostics(s), member=i)

    def history(self, i: int) -> list[dict]:
        b, s = self._slots[i]
        return self.sims[b].histories[s]

    def member_state(self, i: int):
        b, s = self._slots[i]
        return self.sims[b].member_state(s)

    def save_member(self, i: int, path: str) -> None:
        b, s = self._slots[i]
        save_ensemble_member(self.sims[b], s, path)

    def restore_member(self, i: int, path: str) -> None:
        b, s = self._slots[i]
        restore_ensemble_member(self.sims[b], s, path)


def make_ensemble(spec: EnsembleSpec, *, device=None) -> EnsembleRun:
    """Build the buckets an `EnsembleSpec` describes, on ``device`` (default
    ``cuda``): its members grouped by `spec_signature`, one
    `EnsembleSimulation` each, each with its own captured windows."""
    from repro_torch.pic.ensemble import EnsembleSimulation

    device = resolve_device(device)
    members = spec.members()
    slots: list[tuple[int, int]] = [(0, 0)] * len(members)
    sims = []
    for b, idxs in enumerate(bucket_specs(members).values()):
        specs = [members[i] for i in idxs]
        pairs = [(build_fields(m, device=device), build_particles(m, device=device)) for m in specs]
        sims.append(EnsembleSimulation(pairs, pic_config(specs[0]), specs[0].sort.policy, specs=specs))
        for s, i in enumerate(idxs):
            slots[i] = (b, s)
    return EnsembleRun(spec, members, sims, slots)

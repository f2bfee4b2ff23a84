"""The Matrix-PIC simulation loop (paper Algorithm 1), windowed driver.

Counterpart of the single-device windowed path of `repro.pic.simulation`.
One step (`_pic_step`):
  1. fused gather of the six field components at the particles, from the
     `BinSlab` the state carries;
  2. relativistic Boris push and periodic wrap;
  3. incremental GPMA bin update;
  4. one slot-table staging of positions and q·w·v, then the fused
     deposition of Jx/Jy/Jz, rhocell reduction and guard fold;
  5. Yee/CKC Maxwell update.

`Simulation.run(n, window=K)` runs windows of K steps. After each step the
re-sort policy (`core.resort_policy`) decides on the device; the driver
reads that decision, one small integer, on the host and runs the global
sort when it says so (`global_sort_device`), then reads the sort's overflow.
A persistent overflow halts the window; the host grows the bin capacity and
re-enters for the remaining steps. Per-step diagnostics stay on the device
and the host fetches them once per window. `Simulation.host_reads` counts
every device-to-host read a run makes.

Eager PyTorch has no traced conditional, hence the per-step read where the
reference runs `lax.cond` inside a compiled scan; removing it (a CUDA graph
per window, or a masked sort that always runs) is later work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.binning import (
    BinnedLayout,
    BinSlab,
    bin_slab_staging,
    build_bin_slab,
    build_bins,
    cell_index,
    choose_capacity,
    permute_tree,
    sort_permutation,
)
from repro_torch.core.deposition import deposit_current_matrix_fused
from repro_torch.core.gather import gather_fields_fused
from repro_torch.core.gpma import GPMAStats, gpma_update
from repro_torch.core.resort_policy import (
    SortPolicyConfig,
    SortPolicyState,
    policy_init,
    policy_reset,
    policy_update,
)
from repro_torch.core.rhocell import fold_guards, unfold_guards
from repro_torch.core.shape_functions import max_guard
from repro_torch.kernels import dispatch
from repro_torch.pic.grid import FieldState, GridSpec
from repro_torch.pic.maxwell import maxwell_step
from repro_torch.pic.plasma import ParticleState
from repro_torch.pic.pusher import advance_positions, boris_push, lorentz_gamma, wrap_periodic

# halt codes of the windowed driver (the first two of repro.core.health's)
HALT_NONE = 0
HALT_BIN_OVERFLOW = 1
HALT_NAMES = ("none", "bin_overflow")


@dataclasses.dataclass(frozen=True)
class PICConfig:
    """Single-device step configuration. This slice runs the main path
    only: fused matrix deposition and gather, incremental GPMA sort."""

    grid: GridSpec
    dt: float
    order: int = 1
    deposition: str = "matrix"
    gather: str = "matrix"
    sort_mode: str = "incremental"
    charge: float = -1.0
    mass: float = 1.0
    ckc_beta: float = 0.0
    capacity: int = 16
    backend: str = "auto"        # auto | torch | cuda | cuda_reduced (or a reference name)

    def __post_init__(self):
        ported = {"deposition": "matrix", "gather": "matrix", "sort_mode": "incremental"}
        for name, value in ported.items():
            if getattr(self, name) != value:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported to repro_torch yet (only {value!r})"
                )
        object.__setattr__(self, "backend", dispatch.canonical(self.backend))

    @property
    def q_over_m(self) -> float:
        return self.charge / self.mass

    @property
    def guard(self) -> int:
        return max_guard(self.order)


@dataclasses.dataclass(frozen=True)
class PICState:
    fields: FieldState
    particles: ParticleState
    layout: BinnedLayout
    step: int
    # the step's one bin-resident staging slab, always consistent with
    # (particles.pos, layout): the slab the deposition of step n contracts
    # against is the slab the gather of step n+1 reuses
    slab: BinSlab


def _sort_and_bin(particles: ParticleState, config: PICConfig):
    """Permute the particles into cell order, then build their bins and slab.
    Returns (particles, layout, slab, overflow as a device scalar)."""
    cells = cell_index(particles.pos, config.grid.shape)
    particles = permute_tree(particles, sort_permutation(cells, particles.alive))
    cells = cell_index(particles.pos, config.grid.shape)
    layout, overflow = build_bins(cells, particles.alive, n_cells=config.grid.n_cells, capacity=config.capacity)
    slab = build_bin_slab(particles.pos, layout, grid_shape=config.grid.shape)
    return particles, layout, slab, overflow


def init_state(fields: FieldState, particles: ParticleState, config: PICConfig) -> tuple[PICState, int]:
    """Global init (paper Alg. 1 lines 1-5): global sort + GPMA build.
    Returns the state and the binning overflow (one host read)."""
    particles, layout, slab, overflow = _sort_and_bin(particles, config)
    return PICState(fields=fields, particles=particles, layout=layout, step=0, slab=slab), int(overflow)


def padded_fields(fields: FieldState, guard: int) -> torch.Tensor:
    """The six components, stacked in EB_STAGGERS order and periodically
    guard-padded: (6, nx+2g, ny+2g, nz+2g)."""
    return unfold_guards(torch.stack(fields.all()), guard, dims=(1, 2, 3)).contiguous()


def _pic_step(state: PICState, config: PICConfig) -> tuple[PICState, GPMAStats]:
    """One simulation step. Each phase is a `record_function` range
    (``pic.gather`` ... ``pic.maxwell``), so a profiler run attributes the
    device time to the step's layers; without a profiler a range costs a
    few microseconds of host time."""
    p = state.particles
    shape = config.grid.shape
    alive_f = p.alive.to(p.pos.dtype)

    # 1. fused field gather against the carried slab (pre-push positions)
    with record_function("pic.gather"):
        e_p, b_p = gather_fields_fused(
            state.slab, padded_fields(state.fields, config.guard), state.layout,
            grid_shape=shape, order=config.order, backend=config.backend,
        )

    # 2. push
    with record_function("pic.push"):
        alive_col = p.alive[:, None]
        u_new = torch.where(alive_col, boris_push(p.u, e_p, b_p, config.q_over_m, config.dt), p.u)
        pos_new = wrap_periodic(advance_positions(p.pos, u_new, config.dt, config.grid.dx), shape)
        pos_new = torch.where(alive_col, pos_new, p.pos)

    # 3. incremental sort
    with record_function("pic.gpma"):
        layout, stats = gpma_update(state.layout, cell_index(pos_new, shape), p.alive)

    # 4. the step's one slab staging (positions and q·w·v), then deposition
    #    at x^{n+1}, v^{n+1/2}
    with record_function("pic.staging"):
        gamma = lorentz_gamma(u_new)
        v = u_new / gamma[:, None]
        qw = config.charge * p.w * alive_f
        slab, values = bin_slab_staging(pos_new, v, qw, layout, grid_shape=shape)
    with record_function("pic.deposit"):
        j3 = deposit_current_matrix_fused(
            pos_new, v, qw, layout, grid_shape=shape, order=config.order,
            backend=config.backend, slab=slab, values=values,
        )
        inv_vol = 1.0 / config.grid.cell_volume
        j = [fold_guards(jc, config.guard) * inv_vol for jc in j3]

    # 5. fields
    with record_function("pic.maxwell"):
        fields = maxwell_step(state.fields, j, dx=config.grid.dx, dt=config.dt, ckc_beta=config.ckc_beta)
    particles = dataclasses.replace(p, pos=pos_new, u=u_new)
    return PICState(fields=fields, particles=particles, layout=layout, step=state.step + 1, slab=slab), stats


def global_sort_device(state: PICState, config: PICConfig) -> tuple[PICState, torch.Tensor]:
    """GlobalSortParticlesByCell: permute the attributes into cell order and
    rebuild the bins and the slab. The overflow stays a device tensor."""
    particles, layout, slab, overflow = _sort_and_bin(state.particles, config)
    return dataclasses.replace(state, particles=particles, layout=layout, slab=slab), overflow


def global_sort(state: PICState, config: PICConfig) -> tuple[PICState, int]:
    """`global_sort_device` with the overflow read on the host."""
    state, overflow = global_sort_device(state, config)
    return state, int(overflow)


def _energies(state: PICState, config: PICConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(field, kinetic) energy as float32 device scalars — the one
    definition shared by `Simulation.diagnostics` and the window
    diagnostics."""
    p = state.particles
    gamma = lorentz_gamma(p.u)
    alive_f = p.alive.to(torch.float32)
    kinetic = torch.sum(p.w.to(torch.float32) * alive_f * config.mass * (gamma.to(torch.float32) - 1.0))
    return state.fields.energy(config.grid.cell_volume), kinetic


def state_from_reference(arrays: dict[str, np.ndarray], config: PICConfig, device) -> tuple[PICState, SortPolicyState]:
    """The port's state from a reference run's, as numpy arrays.

    ``arrays`` holds the reference `PICState` and `SortPolicyState` leaves
    under these names: ``fields.{ex,ey,ez,bx,by,bz}``,
    ``particles.{pos,u,w,alive}``, ``layout.{slots,particle_slot}``,
    ``step``, ``policy.{steps_since_sort,rebuilds_since_sort,
    baseline_proxy,proxy_ema}`` and, optionally, ``slab.{d,valid}`` (rebuilt
    from positions and layout when absent)."""
    t = lambda name, dtype=None: torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=device)
    fields = FieldState(*(t(f"fields.{n}", torch.float32) for n in ("ex", "ey", "ez", "bx", "by", "bz")))
    particles = ParticleState(
        pos=t("particles.pos", torch.float32), u=t("particles.u", torch.float32),
        w=t("particles.w", torch.float32), alive=t("particles.alive", torch.bool),
    )
    layout = BinnedLayout(slots=t("layout.slots", torch.int32), particle_slot=t("layout.particle_slot", torch.int32))
    if "slab.d" in arrays:
        slab = BinSlab(d=t("slab.d", torch.float32), valid=t("slab.valid", torch.bool))
    else:
        slab = build_bin_slab(particles.pos, layout, grid_shape=config.grid.shape)
    state = PICState(fields=fields, particles=particles, layout=layout, step=int(arrays["step"]), slab=slab)
    pstate = SortPolicyState(
        steps_since_sort=t("policy.steps_since_sort", torch.int32),
        rebuilds_since_sort=t("policy.rebuilds_since_sort", torch.int32),
        baseline_proxy=t("policy.baseline_proxy", torch.float32),
        proxy_ema=t("policy.proxy_ema", torch.float32),
    )
    return state, pstate


UNSET = object()


class Simulation:
    """Windowed single-device driver: step, device re-sort policy, global
    sort on the policy's word, capacity growth on a persistent overflow.

    Build it with `repro_torch.api.make_simulation(spec)`; the state's
    tensors decide the device.
    """

    def __init__(self, fields: FieldState, particles: ParticleState, config: PICConfig,
                 policy: SortPolicyConfig | None = None, *, spec=None):
        self.spec = spec
        self.config = config
        state, overflow = init_state(fields, particles, config)
        if overflow:
            self.config = dataclasses.replace(config, capacity=choose_capacity(config.capacity * 2 // 3 * 2))
            state, overflow = init_state(fields, particles, self.config)
            assert overflow == 0, "initial binning overflow after capacity growth"
        self.state = state
        self.device = particles.pos.device
        self.policy = policy or SortPolicyConfig()
        self.policy_state = policy_init(self.device)
        self.sorts = 0
        self.rebuilds = 0
        self.history: list[dict] = []
        self.halts: dict[str, int] = {}
        self.growths = {"capacity": 0}
        self.windows = 0
        self.host_reads = 0
        self._host_step = 0

    # -- host reads ---------------------------------------------------------

    def _read(self, tensor: torch.Tensor):
        """Every device-to-host read of a run goes through here."""
        self.host_reads += 1
        return tensor.cpu()

    # -- the windowed driver ------------------------------------------------

    def run(self, n_steps: int | None = None, *, diagnostics_every: int | None = None, window=UNSET) -> None:
        """Advance `n_steps` (default: the spec's) in windows of `window`
        steps (default: the spec's). The legacy host-driven loop
        (``window=None``) is not ported."""
        run = None if self.spec is None else self.spec.run
        if n_steps is None:
            if run is None:
                raise TypeError("run() needs n_steps (this driver has no spec defaults)")
            n_steps = run.steps
        if diagnostics_every is None:
            diagnostics_every = 0 if run is None else run.diagnostics_every
        if window is UNSET:
            window = None if run is None else (run.window or None)
        if window is None:
            raise NotImplementedError("the host-driven per-step loop is not ported: pass window=K")
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        target = self._host_step + n_steps
        while self._host_step < target:
            k = min(window, target - self._host_step)
            host = self._run_window(k, with_energies=bool(diagnostics_every))
            n_done = self._consume(host, diagnostics_every)
            code = int(host["halt_code"])
            if code == HALT_BIN_OVERFLOW:
                self.halts[HALT_NAMES[code]] = self.halts.get(HALT_NAMES[code], 0) + 1
                self._grow_capacity()
            elif n_done < k:
                raise RuntimeError("windowed driver made no progress without a halt")

    def _run_window(self, k: int, *, with_energies: bool) -> dict:
        """Up to k steps; stops after a step whose global sort still
        overflows. Returns the window's host bundle (one read)."""
        config, policy = self.config, self.policy
        n_slots = config.grid.n_cells * config.capacity
        state, pstate = self.state, self.policy_state
        per_step = []
        sorts = rebuilds = 0
        halt_code = HALT_NONE
        for _ in range(k):
            state, stats = _pic_step(state, config)
            with record_function("pic.policy"):
                mandatory = stats.n_overflow > 0
                do_pol, _reason, recorded = policy_update(
                    pstate, policy, n_moved=stats.n_moved, n_alive=stats.n_alive,
                    n_empty=stats.n_empty, n_slots=n_slots,
                )
                do_pol = do_pol & ~mandatory
                # the step's one read: 0 no sort, 1 policy sort, 2 overflow rebuild
                decision = int(self._read(2 * mandatory.to(torch.int32) + do_pol.to(torch.int32)))
            overflow_after = 0
            if decision:
                with record_function("pic.global_sort"):
                    state, overflow = global_sort_device(state, config)
                    overflow_after = int(self._read(overflow))
                pstate = policy_reset(self.device)
                sorts += decision == 1
                rebuilds += decision == 2
            else:
                pstate = recorded
            diag = {"n_moved": stats.n_moved, "n_alive": stats.n_alive}
            if with_energies:
                diag["field_energy"], diag["kinetic_energy"] = _energies(state, config)
            per_step.append(diag)
            if overflow_after > 0:
                halt_code = HALT_BIN_OVERFLOW
                break
        self.state, self.policy_state = state, pstate
        self.windows += 1
        # the window's one bundle read: every per-step diagnostic, as float64
        names = list(per_step[0])
        table = torch.stack([torch.stack([d[n].to(torch.float64) for d in per_step]) for n in names])
        return {
            "n_done": len(per_step),
            "n_sorts": sorts,
            "n_rebuilds": rebuilds,
            "halt_code": halt_code,
            "per_step": dict(zip(names, self._read(table).numpy())),
        }

    def _consume(self, host: dict, diagnostics_every: int) -> int:
        n_done = host["n_done"]
        if diagnostics_every:
            per = host["per_step"]
            for i in range(n_done):
                step_abs = self._host_step + i + 1
                if step_abs % diagnostics_every == 0:
                    fe = float(per["field_energy"][i])
                    ke = float(per["kinetic_energy"][i])
                    self.history.append({
                        "step": step_abs,
                        "field_energy": fe,
                        "kinetic_energy": ke,
                        "total_energy": fe + ke,
                        "n_alive": int(per["n_alive"][i]),
                        "n_moved": int(per["n_moved"][i]),
                    })
        self.sorts += host["n_sorts"]
        self.rebuilds += host["n_rebuilds"]
        self._host_step += n_done
        return n_done

    # -- capacity growth ----------------------------------------------------

    def _needed_capacity(self) -> int:
        """Occupancy of the densest cell in the current state."""
        p = self.state.particles
        cells = cell_index(p.pos, self.config.grid.shape)
        counts = torch.zeros(self.config.grid.n_cells, dtype=torch.int64, device=self.device)
        counts.index_add_(0, cells, p.alive.to(torch.int64))
        return int(self._read(counts.max()))

    def _grow_capacity(self) -> None:
        """Grow the bin capacity once to fit the densest cell (with the
        standard headroom, at least doubling) and re-bin the current state,
        keeping its fields, particles and step."""
        needed = self._needed_capacity()
        new_cap = max(choose_capacity(needed), self.config.capacity * 2)
        self.config = dataclasses.replace(self.config, capacity=new_cap)
        self.growths["capacity"] = self.growths.get("capacity", 0) + 1
        self.state, overflow = global_sort_device(self.state, self.config)
        assert int(self._read(overflow)) == 0, "binning overflow persists after sizing capacity to the densest cell"

    # -- diagnostics --------------------------------------------------------

    def diagnostics(self) -> dict:
        s = self.state
        field_e, kinetic_e = _energies(s, self.config)
        em, kinetic = float(field_e), float(kinetic_e)
        return {
            "step": s.step,
            "field_energy": em,
            "kinetic_energy": kinetic,
            "total_energy": em + kinetic,
            "n_alive": int(torch.sum(s.particles.alive)),
        }

"""The Matrix-PIC simulation loop (paper Algorithm 1): the single-device
driver, windowed and host-driven.

Counterpart of the single-device part of `repro.pic.simulation`. One step
(`_pic_step`):
  1. field gather of the six components at the particles: fused, from the
     `BinSlab` the state carries (``gather="matrix"``), six calls of the
     binned matrix gather (``matrix_unfused``) or per particle
     (``scatter``);
  2. relativistic Boris push and periodic wrap;
  3. the bin update of the sort mode: the incremental GPMA update
     (``incremental``), a rebuild of the bins from scratch (``rebuild``,
     and ``global``, whose window then sorts every step), or none
     (``none``, for the paths that need no bins);
  4. current deposition: one slot-table staging of positions and q·w·v,
     then the fused deposition of Jx/Jy/Jz (``deposition="matrix"``), or one
     component at a time (``matrix_unfused``, ``scatter``, ``rhocell``);
     rhocell reduction and guard fold;
  5. Yee/CKC Maxwell update.

The sort modes are the paper's ablation axes: ``incremental`` is FullOpt
(GPMA and the adaptive policy), ``rebuild`` Matrix-only (bins rebuilt every
step, no attribute permutation), ``global`` Hybrid-GlobalSort (a full sort,
attributes permuted, every step), ``none`` the scatter baseline's.

Two drivers wrap the step:

* `Simulation.run(n, window=K)` runs windows of K steps. A window step
  (`_window_step`) runs the step and the mode's decision in place on the
  window's buffers: in ``incremental`` the re-sort policy
  (`core.resort_policy`) and, on its word or on an overflow, the global
  sort (`global_sort_device`); in ``global`` the global sort every step; in
  ``rebuild`` nothing. A sort, or a rebuild, that still overflows halts
  the window. A decision goes to a decider (`kernels.conditional`): on the
  CPU it is tested on the host; on a CUDA device the guarded step is
  captured once as a CUDA graph in which decisions are IF nodes, and a
  window is k replays and one read of a bundle of counters and per-step
  diagnostics. The host then grows the bin capacity after a halt (the
  shapes change, so the step is captured anew) and re-enters for the
  remaining steps.
* `Simulation.run(n, window=None)` (a spec's ``run.window == 0``) is the
  host-driven loop the reference keeps for comparison: one eager step per
  iteration, its statistics read on the host and the host policy
  (`ResortPolicy`, with its wall-clock performance trigger) deciding.
  No CUDA graph is used.

The windowed driver runs under the supervisor of
`repro_torch.distributed.fault` (`run_supervised_windows`). With the spec's
``health.enable`` the window step ends with the health sentinel
(`core.health`): non-finite fields or momenta, or charge or energy drifting
from their values at window entry, halt the window, and the host rolls it
back to a snapshot taken at its entry and retries under the remedy ladder
(halve the window, force a global sort, demote the kernel backend). A
spec's ``fault`` injects a fault into the step's input on the device, or a
crash on the host; ``run(autosave_every=N)`` keeps rolling checkpoints and
restores the latest after an exception. The halt's code, step, invariant
and measured and reference values travel in the window's one bundle.

`Simulation.host_reads` counts every device-to-host read a run makes: one
per window (a halted window included), two more per capacity growth, one
per forced sort of the ladder; about three a step in the host-driven loop.
`Simulation.save` and `Simulation.restore` write and read the reference's
checkpoint format (`repro_torch.checkpoint`).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
import warnings
from collections import OrderedDict

import numpy as np
import torch
import torch.utils.checkpoint
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
from repro_torch.core.deposition import (
    CURRENT_STAGGER,
    deposit_current_matrix_fused,
    deposit_matrix,
    deposit_rhocell,
    deposit_scatter,
)
from repro_torch.core.gather import EB_STAGGERS, gather_fields_fused, gather_matrix, gather_scatter
from repro_torch.core.gpma import GPMAStats, gpma_update
from repro_torch.core.health import (
    HALT_BIN_OVERFLOW,
    HALT_NAMES,
    HALT_NONE,
    HealthConfig,
    classify_health,
    nonfinite_count,
)
from repro_torch.core.resort_policy import (
    REASON_OVERFLOW,
    ResortPolicy,
    SortPolicyConfig,
    SortPolicyState,
    policy_init,
    policy_reset,
    policy_update,
)
from repro_torch.core.rhocell import fold_guards, unfold_guards
from repro_torch.core.shape_functions import max_guard
from repro_torch import kernels
from repro_torch.kernels import dispatch
from repro_torch.distributed.fault import (
    FAULT_NONE,
    PICFaultInjector,
    inject_fields,
    inject_momenta,
    inject_weights,
    run_supervised_windows,
)
from repro_torch.grad.remat import move_tree
from repro_torch.kernels.conditional import EveryBranch, GraphCapture, HostDecider
from repro_torch.pic.grid import FieldState, GridSpec
from repro_torch.pic.maxwell import maxwell_step
from repro_torch.pic.plasma import ParticleState
from repro_torch.pic.pusher import advance_positions, boris_push, lorentz_gamma, wrap_periodic


DEPOSITION_MODES = ("matrix", "matrix_unfused", "scatter", "rhocell")
GATHER_MODES = ("matrix", "matrix_unfused", "scatter")
SORT_MODES = ("incremental", "rebuild", "global", "none")


@dataclasses.dataclass(frozen=True)
class PICConfig:
    """Single-device step configuration: every deposition x gather x sort
    mode of the reference."""

    grid: GridSpec
    dt: float
    order: int = 1
    deposition: str = "matrix"   # matrix (fused) | matrix_unfused | scatter | rhocell
    gather: str = "matrix"       # matrix (fused) | matrix_unfused (six-call) | scatter
    sort_mode: str = "incremental"  # incremental | rebuild | global | none
    charge: float = -1.0
    mass: float = 1.0
    ckc_beta: float = 0.0
    capacity: int = 16
    backend: str = "auto"        # auto | torch | cuda | cuda_reduced (or a reference name)

    def __post_init__(self):
        if self.deposition not in DEPOSITION_MODES:
            raise ValueError(f"unknown deposition mode {self.deposition!r}; known: {DEPOSITION_MODES}")
        if self.gather not in GATHER_MODES:
            raise ValueError(f"unknown gather mode {self.gather!r}; known: {GATHER_MODES}")
        if self.sort_mode not in SORT_MODES:
            raise ValueError(f"unknown sort mode {self.sort_mode!r}; known: {SORT_MODES}")
        object.__setattr__(self, "backend", dispatch.canonical(self.backend))

    @property
    def q_over_m(self) -> float:
        return self.charge / self.mass

    @property
    def guard(self) -> int:
        return max_guard(self.order)

    @property
    def needs_bins(self) -> bool:
        return self.deposition in ("matrix", "matrix_unfused") or self.gather in ("matrix", "matrix_unfused")

    @property
    def needs_slab(self) -> bool:
        """Whether the step stages (and the state carries) a `BinSlab`:
        exactly when a fused bin kernel consumes it."""
        return self.deposition == "matrix" or self.gather == "matrix"


@dataclasses.dataclass(frozen=True)
class PICState:
    fields: FieldState
    particles: ParticleState
    layout: BinnedLayout
    step: int
    # the step's one bin-resident staging slab (None unless a fused bin
    # kernel consumes it, `PICConfig.needs_slab`), always consistent with
    # (particles.pos, layout): the slab the deposition of step n contracts
    # against is the slab the gather of step n+1 reuses
    slab: BinSlab | None = None


def _state_slab(particles: ParticleState, layout: BinnedLayout, config: PICConfig) -> BinSlab | None:
    """The one slot-table slab staging of a step (see `BinSlab`)."""
    if not config.needs_slab:
        return None
    return build_bin_slab(particles.pos, layout, grid_shape=config.grid.shape)


def _sort_and_bin(particles: ParticleState, config: PICConfig):
    """Permute the particles into cell order, then build their bins and slab.
    Returns (particles, layout, slab, overflow as a device scalar)."""
    cells = cell_index(particles.pos, config.grid.shape)
    particles = permute_tree(particles, sort_permutation(cells, particles.alive))
    cells = cell_index(particles.pos, config.grid.shape)
    layout, overflow = build_bins(cells, particles.alive, n_cells=config.grid.n_cells, capacity=config.capacity)
    return particles, layout, _state_slab(particles, layout, config), overflow


def init_state(fields: FieldState, particles: ParticleState, config: PICConfig) -> tuple[PICState, int]:
    """Global init (paper Alg. 1 lines 1-5): global sort + GPMA build.
    Returns the state and the binning overflow (one host read)."""
    particles, layout, slab, overflow = _sort_and_bin(particles, config)
    return PICState(fields=fields, particles=particles, layout=layout, step=0, slab=slab), int(overflow)


def padded_fields(fields: FieldState, guard: int) -> torch.Tensor:
    """The six components, stacked in EB_STAGGERS order and periodically
    guard-padded: ([B,] 6, nx+2g, ny+2g, nz+2g)."""
    return unfold_guards(torch.stack(fields.all(), dim=-4), guard, dims=(-3, -2, -1)).contiguous()


def _gather_fields(pos, fields: FieldState, layout: BinnedLayout, slab: BinSlab | None, config: PICConfig):
    """E and B at the particles, ([B,] Np, 3) each, by the configured gather."""
    shape, order = config.grid.shape, config.order
    padded = padded_fields(fields, config.guard)
    if config.gather == "matrix":
        return gather_fields_fused(slab, padded, layout, grid_shape=shape, order=order, backend=config.backend)
    comps = []
    for k, stagger in enumerate(EB_STAGGERS):
        if config.gather == "matrix_unfused":
            comps.append(gather_matrix(pos, padded[..., k, :, :, :], layout, grid_shape=shape, order=order,
                                       stagger=stagger, backend=config.backend))
        else:
            comps.append(gather_scatter(pos, padded[..., k, :, :, :], order=order, stagger=stagger))
    return torch.stack(comps[:3], dim=-1), torch.stack(comps[3:], dim=-1)


def _deposit_current(pos, v, qw, layout: BinnedLayout, slab: BinSlab | None, cells, config: PICConfig, values=None):
    """[Jx, Jy, Jz], folded and divided by the cell volume, by the
    configured deposition."""
    shape, order = config.grid.shape, config.order
    inv_vol = 1.0 / config.grid.cell_volume
    if config.deposition == "matrix":
        j3 = deposit_current_matrix_fused(pos, v, qw, layout, grid_shape=shape, order=order,
                                          backend=config.backend, slab=slab, values=values)
        return [fold_guards(j, config.guard) * inv_vol for j in j3]
    out = []
    for k, stagger in enumerate(CURRENT_STAGGER):
        values = qw * v[..., k]
        if config.deposition == "scatter":
            j = deposit_scatter(pos, values, grid_shape=shape, order=order, stagger=stagger)
        elif config.deposition == "rhocell":
            j = deposit_rhocell(pos, values, cells, grid_shape=shape, order=order, stagger=stagger)
        else:
            j = deposit_matrix(pos, values, layout, grid_shape=shape, order=order, stagger=stagger,
                               backend=config.backend)
        out.append(fold_guards(j, config.guard) * inv_vol)
    return out


def _count(mask: torch.Tensor) -> torch.Tensor:
    """The true entries of a per-particle mask: a 0-d int64 tensor, or one
    a member (B,) with a member axis."""
    return torch.sum(mask, dim=-1) if mask.dim() > 1 else torch.sum(mask)


def _pic_step(state: PICState, config: PICConfig) -> tuple[PICState, GPMAStats]:
    """One simulation step. Each phase is a `record_function` range
    (``pic.gather`` ... ``pic.maxwell``), so a profiler run attributes the
    device time to the step's layers; without a profiler a range costs a
    few microseconds of host time.

    The state may carry a leading member axis on every tensor (an ensemble
    bucket's, `repro_torch.pic.ensemble`): the step then advances every
    member at once, each kernel launched once for all of them, and each
    member's result is its solo step's; the statistics are one a member."""
    p = state.particles
    shape = config.grid.shape
    alive_f = p.alive.to(p.pos.dtype)

    # 1. field gather (bins and the carried slab are current with respect
    #    to the pre-push positions)
    with record_function("pic.gather"):
        e_p, b_p = _gather_fields(p.pos, state.fields, state.layout, state.slab, config)

    # 2. push
    with record_function("pic.push"):
        alive_col = p.alive[..., None]
        u_new = torch.where(alive_col, boris_push(p.u, e_p, b_p, config.q_over_m, config.dt), p.u)
        pos_new = wrap_periodic(advance_positions(p.pos, u_new, config.dt, config.grid.dx), shape)
        pos_new = torch.where(alive_col, pos_new, p.pos)

    # 3. the bin update of the sort mode
    with record_function("pic.gpma"):
        new_cells = cell_index(pos_new, shape)
        if config.sort_mode == "incremental":
            layout, stats = gpma_update(state.layout, new_cells, p.alive)
        elif config.sort_mode in ("rebuild", "global"):
            layout, overflow = build_bins(new_cells, p.alive, n_cells=config.grid.n_cells, capacity=config.capacity)
            stats = GPMAStats(n_moved=_count(new_cells != cell_index(p.pos, shape)), n_overflow=overflow,
                              n_empty=layout.n_empty(), n_alive=_count(p.alive))
        else:  # none: the layout stays as it is
            layout = state.layout
            zero = torch.zeros(p.alive.shape[:-1], dtype=torch.int64, device=p.pos.device)
            stats = GPMAStats(n_moved=zero, n_overflow=zero, n_empty=zero, n_alive=_count(p.alive))

    # 4. the step's one slab staging (the fused deposition stages positions
    #    and q·w·v together), then deposition at x^{n+1}, v^{n+1/2}
    particles = dataclasses.replace(p, pos=pos_new, u=u_new)
    with record_function("pic.staging"):
        gamma = lorentz_gamma(u_new)
        v = u_new / gamma[..., None]
        qw = config.charge * p.w * alive_f
        values = None
        if config.deposition == "matrix":
            slab, values = bin_slab_staging(pos_new, v, qw, layout, grid_shape=shape)
        else:
            slab = _state_slab(particles, layout, config)
    with record_function("pic.deposit"):
        j = _deposit_current(pos_new, v, qw, layout, slab, new_cells, config, values=values)

    # 5. fields
    with record_function("pic.maxwell"):
        fields = maxwell_step(state.fields, j, dx=config.grid.dx, dt=config.dt, ckc_beta=config.ckc_beta)
    return PICState(fields=fields, particles=particles, layout=layout, step=state.step + 1, slab=slab), stats


def pic_step(state: PICState, config: PICConfig) -> tuple[PICState, GPMAStats]:
    """One simulation step, `_pic_step` under the reference's name: returns
    ``(state, stats)`` in fresh tensors, leaving the input as it is. The
    state's ``step`` may be an int or a 0-d tensor."""
    return _pic_step(state, config)


#: the reference's donating variant; in PyTorch a step never writes its
#: input, so it is the same function
pic_step_donated = pic_step


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


def _total_charge(state: PICState) -> torch.Tensor:
    """The sum of the alive weights, float32: the step conserves it exactly,
    so the sentinel holds it to its value at window entry."""
    p = state.particles
    return torch.sum(p.w.to(torch.float32) * p.alive.to(torch.float32))


def _apply_fault(state: PICState, step_count: torch.Tensor, fault_vec: torch.Tensor) -> PICState:
    """The chaos harness's hook: the step's input, corrupted where the armed
    fault vector fires at ``step_count`` (see `distributed.fault.FaultSpec`).
    Only a window of a driver with a fault spec runs it."""
    fields = FieldState(*inject_fields(state.fields.all(), step_count, fault_vec))
    p = state.particles
    particles = dataclasses.replace(p, u=inject_momenta(p.u, step_count, fault_vec),
                                    w=inject_weights(p.w, step_count, fault_vec))
    return dataclasses.replace(state, fields=fields, particles=particles)


def _sentinel(state: PICState, health: HealthConfig, energies, ref_charge, ref_energy):
    """The health sentinel's reads of a post-step state, classified
    (`core.health.classify_health`): (code, invariant, measured,
    reference). ``energies`` is the step's (field, kinetic) pair, or None
    when the energy check is off."""
    p = state.particles
    zero_i = torch.zeros((), dtype=torch.int32, device=p.pos.device)
    ff = mf = zero_i
    if health.check_nonfinite:
        ff = nonfinite_count(state.fields.all())
        mf = nonfinite_count([p.u, p.pos], mask=p.alive)
    energy = torch.zeros((), dtype=torch.float32, device=p.pos.device) if energies is None else energies[0] + energies[1]
    return classify_health(health, fields_nonfinite=ff, momenta_nonfinite=mf, charge=_total_charge(state),
                           charge_ref=ref_charge, energy=energy, energy_ref=ref_energy)


def state_from_reference(arrays: dict[str, np.ndarray], config: PICConfig, device) -> tuple[PICState, SortPolicyState]:
    """The port's state from a run's numpy arrays: a reference run's, or a
    checkpoint's (`repro_torch.checkpoint.restore_simulation`).

    ``arrays`` holds the reference `PICState` and `SortPolicyState` leaves
    under these names: ``fields.{ex,ey,ez,bx,by,bz}``,
    ``particles.{pos,u,w,alive}``, ``layout.{slots,particle_slot}``,
    ``step``, ``policy.{steps_since_sort,rebuilds_since_sort,
    baseline_proxy,proxy_ema}`` and, optionally, ``slab.{d,valid}``. A
    config that carries a slab (`PICConfig.needs_slab`) rebuilds it from
    positions and layout when the arrays have none; one that carries none
    ignores it."""
    t = lambda name, dtype=None: torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=device)
    fields = FieldState(*(t(f"fields.{n}", torch.float32) for n in ("ex", "ey", "ez", "bx", "by", "bz")))
    particles = ParticleState(
        pos=t("particles.pos", torch.float32), u=t("particles.u", torch.float32),
        w=t("particles.w", torch.float32), alive=t("particles.alive", torch.bool),
    )
    layout = BinnedLayout(slots=t("layout.slots", torch.int32), particle_slot=t("layout.particle_slot", torch.int32))
    slab = None
    if config.needs_slab and "slab.d" in arrays:
        slab = BinSlab(d=t("slab.d", torch.float32), valid=t("slab.valid", torch.bool))
    elif config.needs_slab:
        slab = build_bin_slab(particles.pos, layout, grid_shape=config.grid.shape)
    state = PICState(fields=fields, particles=particles, layout=layout, step=int(arrays["step"]), slab=slab)
    pstate = SortPolicyState(
        steps_since_sort=t("policy.steps_since_sort", torch.int32),
        rebuilds_since_sort=t("policy.rebuilds_since_sort", torch.int32),
        baseline_proxy=t("policy.baseline_proxy", torch.float32),
        proxy_ema=t("policy.proxy_ema", torch.float32),
    )
    return state, pstate


# -- the differentiable window ----------------------------------------------------

REMAT_POLICIES = ("step", "chunk", "none")


def _diff_steps(state: PICState, pstate: SortPolicyState, k: int, config: PICConfig, policy: SortPolicyConfig,
                with_energies: bool):
    """Up to k steps of the differentiable window, stopping after a step
    that halts: each `_pic_step`, then the sort mode's decision and the
    halt, as `_window_step` decides them, but functionally (no input is
    written) and with the decision read on the host. Returns the state,
    the policy state and a record a step: the host's decisions (``do_pol``,
    ``mandatory``, ``sorted``, ``halt``) and the step's diagnostics as 0-d
    tensors."""
    n_slots = config.grid.n_cells * config.capacity
    records = []
    for _ in range(k):
        state, stats = _pic_step(state, config)
        dev = state.particles.pos.device
        do_pol = mandatory = halt = sorted_ = False
        reason = torch.zeros((), dtype=torch.int32, device=dev)
        if config.sort_mode == "incremental":
            if config.needs_bins:
                mandatory_t = stats.n_overflow > 0
            else:
                mandatory_t = torch.zeros((), dtype=torch.bool, device=dev)
            do_pol_t, reason_pol, recorded = policy_update(pstate, policy, n_moved=stats.n_moved,
                                                           n_alive=stats.n_alive, n_empty=stats.n_empty,
                                                           n_slots=n_slots)
            do_pol_t = do_pol_t & ~mandatory_t
            do_pol, mandatory = torch.stack([do_pol_t, mandatory_t]).tolist()  # the step's host read
            sorted_ = do_pol or mandatory
            if sorted_:
                state, overflow = global_sort_device(state, config)
                pstate = policy_reset(dev)
                halt = bool(overflow > 0)
            else:
                pstate = recorded
            reason = torch.where(mandatory_t, REASON_OVERFLOW, reason_pol).to(torch.int32)
        elif config.sort_mode == "global":
            state, overflow = global_sort_device(state, config)
            sorted_, halt = True, bool(overflow > 0)
        elif config.sort_mode == "rebuild":
            halt = bool(stats.n_overflow > 0)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        field_e, kinetic = _energies(state, config) if with_energies else (zero, zero)
        records.append({"do_pol": do_pol, "mandatory": mandatory, "sorted": sorted_, "halt": halt,
                        "reason": reason, "n_moved": stats.n_moved.to(torch.int32),
                        "n_alive": stats.n_alive.to(torch.int32), "field_energy": field_e,
                        "kinetic_energy": kinetic})
        if halt:
            break
    return state, pstate, records


def _diff_unit(kept: PICState, pstate: SortPolicyState, k: int, steps, device, config: PICConfig):
    """A checkpointed unit of the differentiable window: the kept input
    state back on ``device`` with its slab rebuilt, then ``steps(state,
    pstate, k)``."""
    fields, particles, layout = (move_tree(t, device) for t in (kept.fields, kept.particles, kept.layout))
    state = PICState(fields=fields, particles=particles, layout=layout, step=kept.step,
                     slab=_state_slab(particles, layout, config))
    return steps(state, move_tree(pstate, device), k)


def run_window_diff(state: PICState, policy_state: SortPolicyState, config: PICConfig, n_steps: int, *,
                    policy: SortPolicyConfig | None = None, with_energies: bool = False, n_target=None,
                    remat: str = "step", remat_chunk: int = 0):
    """The differentiable window: the windowed run's physics, step for step,
    as a function autograd can differentiate. Counterpart of
    `repro.pic.simulation.run_window_diff`.

    The forward is bit-identical to a windowed `Simulation` run on backend
    ``torch`` from the same state, under every remat policy. What differs
    is autograd plumbing:

    * nothing is written in place: the step is `_pic_step` and the sort
      mode's decision as functions (the driver's `_WindowBuffers` path
      overwrites its buffers, which autograd cannot follow);
    * the sort decision and the halt are read on the host once a step (a
      second read on a step that sorts), where the captured window tests
      them in IF nodes: autograd records no branch on the device;
    * the health sentinel, fault injection and CUDA graph capture are left
      out;
    * ``remat`` sets the recomputation of the reverse pass, through
      `torch.utils.checkpoint` (non-reentrant): ``"step"`` (default)
      checkpoints each step, so the backward keeps only each step's input
      state and recomputes one step at a time; ``"chunk"`` checkpoints
      ``remat_chunk``-step sub-windows, which must divide ``n_steps``;
      ``"none"`` stores every step's residuals. A kept input state has no
      slab (it is rebuilt from positions and bins, with the same bits) and
      waits on the host when the window runs on a card, so the device's
      peak memory does not grow with the window. A recompute takes the
      branch the first pass took: the decisions are integer functions of
      inputs that no step writes.

    Steps from ``n_target`` on, and after a halting step, are not run; the
    reference masks them, which gives the same values and gradients.

    Needs ``config.backend == "torch"`` (the reference's ``"xla"``): the CUDA
    kernel backends, like the reference's Pallas ones, have no VJP, and
    ``"auto"`` could resolve to one.

    Returns ``(state, policy_state, bundle)`` with the reference's bundle
    keys; its counters and halt fields are host values (Python ints,
    floats and bools), ``per_step`` holds (n_steps,) device tensors, zero on
    the steps not run."""
    if config.backend != "torch":
        raise ValueError(f"run_window_diff needs config.backend='torch' (the reference's 'xla'; got "
                         f"{config.backend!r}): the CUDA kernel backends have no VJP")
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r} (none | step | chunk)")
    if remat == "chunk" and (remat_chunk <= 0 or n_steps % remat_chunk):
        raise ValueError(f"remat='chunk' needs remat_chunk > 0 dividing n_steps, got remat_chunk={remat_chunk}, "
                         f"n_steps={n_steps}")
    n_target = n_steps if n_target is None else max(0, min(int(n_target), n_steps))
    steps = functools.partial(_diff_steps, config=config, policy=policy or SortPolicyConfig(),
                              with_energies=with_energies)
    unit = {"step": 1, "chunk": remat_chunk, "none": n_steps}[remat]
    dev = state.particles.pos.device
    pstate, records = policy_state, []
    step0 = state.step
    while len(records) < n_target and not (records and records[-1]["halt"]):
        k = min(unit, n_target - len(records))
        if remat == "none":
            state, pstate, recs = steps(state, pstate, k)
        else:
            # the checkpoint keeps its inputs until the backward
            keep = torch.device("cpu")
            kept = PICState(fields=move_tree(state.fields, keep), particles=move_tree(state.particles, keep),
                            layout=move_tree(state.layout, keep), step=state.step)
            state, pstate, recs = torch.utils.checkpoint.checkpoint(
                _diff_unit, kept, move_tree(pstate, keep), k, steps, dev, config, use_reentrant=False,
                preserve_rng_state=False)
        records += recs
    n_done = len(records)
    halted = bool(records) and records[-1]["halt"]

    def column(values, dtype):
        out = torch.zeros(n_steps, dtype=dtype, device=dev)
        if values:
            tensors = isinstance(values[0], torch.Tensor)
            out[:n_done] = torch.stack(values).to(dtype) if tensors else torch.tensor(values, dtype=dtype)
        return out

    per_step = {"active": column([True] * n_done, torch.bool)}
    for key, dtype in (("sorted", torch.bool), ("reason", torch.int32), ("n_moved", torch.int32),
                       ("n_alive", torch.int32), ("field_energy", torch.float32), ("kinetic_energy", torch.float32)):
        per_step[key] = column([r[key] for r in records], dtype)
    bundle = {
        "n_done": n_done,
        "n_sorts": sum(r["do_pol"] for r in records),
        "n_rebuilds": sum(r["mandatory"] for r in records),
        "overflow_pending": halted,
        "halt_code": HALT_BIN_OVERFLOW if halted else HALT_NONE,
        "halt_step": step0 + n_done if halted else -1,
        "halt_inv": 0,
        "halt_measured": 0.0,
        "halt_reference": 0.0,
        "per_step": per_step,
    }
    return state, pstate, bundle


# -- the window in place --------------------------------------------------------


def _clone_tree(tree):
    """A dataclass of tensors with every tensor cloned."""
    return dataclasses.replace(tree, **{f.name: getattr(tree, f.name).clone() for f in dataclasses.fields(tree)})


def _copy_tree(dst, src, keep: torch.Tensor | None = None) -> None:
    """Write every tensor of ``src`` into the same-named tensor of ``dst``;
    with ``keep`` (B,) (trees with a leading member axis), only the members
    it marks, the others left as they are."""
    for f in dataclasses.fields(dst):
        d, s = getattr(dst, f.name), getattr(src, f.name)
        if d is s:
            continue
        if keep is None:
            d.copy_(s)
        else:  # in place: one pass over both
            torch.where(keep.reshape(-1, *([1] * (d.dim() - 1))), s, d, out=d)


def _member_tree(tree, i: int):
    """Member i of a tree with a leading member axis: its tensors' views."""
    return dataclasses.replace(tree, **{f.name: getattr(tree, f.name)[i] for f in dataclasses.fields(tree)})


class _WindowHead:
    """What the buffers of every windowed driver share: the counters and
    the halt latch named in ``HEAD`` (zeroed at a window's entry and packed
    first in its bundle, a row per member where they carry a member axis)
    and the entry vector ``entry`` that the host writes."""

    HEAD = ("n_done", "halted", "sorts", "rebuilds", "halt_code", "halt_inv", "halt_meas", "halt_ref")

    def _write_entry(self, rows) -> None:
        """Write the entry vector from the host without waiting on the
        device: on CUDA an asynchronous copy from pinned memory (the caching
        host allocator keeps the block until the copy is done)."""
        host = torch.as_tensor(rows, dtype=torch.int64).reshape(self.entry.shape)
        if self.entry.device.type == "cuda":
            host = host.pin_memory()
        self.entry.copy_(host, non_blocking=True)

    def reset_counters(self) -> None:
        for name in self.HEAD:
            getattr(self, name).zero_()

    def bundle(self, k: int) -> torch.Tensor:
        """The ``HEAD`` values and the first k columns of the diagnostics
        table as one float64 vector (a row per member)."""
        head = torch.stack([getattr(self, name).to(torch.float64) for name in self.HEAD], dim=-1)
        return torch.cat([head, self.diag[..., :k].reshape(*self.n_done.shape, -1)], dim=-1)


class _WindowBuffers(_WindowHead):
    """The window's state held in place, in tensors of its own: the tensors
    a step reads and then overwrites, the policy state, the window's
    counters, the sentinel's halt latch and the per-step diagnostics table
    (a row for each of ``names``). On the card they are the captured
    graph's inputs and outputs, at fixed addresses; the step function is
    the same everywhere.

    ``entry`` is what the host (or, for a functional window, the device)
    writes at the entry of a window, in one copy: the absolute step the
    window starts at (``step0``), the fault vector (``fault``: kind, step,
    component) and the window's step target (``target``: a step runs only
    while ``n_done < target``). ``ref_charge`` and ``ref_energy`` are the
    sentinel's references, taken on the device at window entry.

    With ``members=B`` the buffers are an ensemble bucket's
    (`repro_torch.pic.ensemble`): the state's tensors carry a leading member
    axis; every counter, the latch, the table and the entry vector get the
    same axis. The window step then advances every member at once and keeps
    a member's new state only while it is active: not halted and ``n_done <
    target``."""

    def __init__(self, state: PICState, pstate: SortPolicyState, names: tuple[str, ...], n_diag: int,
                 members: int | None = None):
        dev = state.particles.pos.device
        self.device = dev
        self.fields = _clone_tree(state.fields)
        self.particles = _clone_tree(state.particles)
        self.layout = _clone_tree(state.layout)
        self.slab = None if state.slab is None else _clone_tree(state.slab)
        self.pstate = _clone_tree(pstate)
        self.names = names
        self.members = members
        lead = () if members is None else (members,)
        self.diag = torch.zeros((*lead, len(names), n_diag), dtype=torch.float64, device=dev)
        zeros = lambda dtype: torch.zeros(lead, dtype=dtype, device=dev)
        self.n_done, self.sorts, self.rebuilds = zeros(torch.int64), zeros(torch.int64), zeros(torch.int64)
        self.halted = zeros(torch.bool)
        # the sentinel's halt latch: code, invariant, measured, reference
        self.halt_code, self.halt_inv = zeros(torch.int32), zeros(torch.int32)
        self.halt_meas, self.halt_ref = zeros(torch.float32), zeros(torch.float32)
        row = [0, FAULT_NONE, -1, 0, 0]
        self.entry = torch.tensor([row] * members if members is not None else row, dtype=torch.int64, device=dev)
        self.step0, self.fault, self.target = self.entry[..., 0], self.entry[..., 1:4], self.entry[..., 4]
        self.ref_charge, self.ref_energy = zeros(torch.float32), zeros(torch.float32)

    def state(self, step: int = 0) -> PICState:
        return PICState(fields=self.fields, particles=self.particles, layout=self.layout, step=step, slab=self.slab)

    def store(self, state: PICState, keep: torch.Tensor | None = None) -> None:
        """Write ``state`` into the buffers (with ``keep``, a bucket's, only
        the members it marks)."""
        _copy_tree(self.fields, state.fields, keep)
        _copy_tree(self.particles, state.particles, keep)
        _copy_tree(self.layout, state.layout, keep)
        if self.slab is not None:
            _copy_tree(self.slab, state.slab, keep)

    def record(self, row: list, keep: torch.Tensor | None) -> None:
        """The step's diagnostics ``row`` into column ``n_done`` of the
        table: for a bucket, each member's at its own ``n_done``, and only
        where ``keep`` marks it (a member past its window's end writes
        nothing)."""
        values = torch.stack([r.to(torch.float64) for r in row], dim=-1)
        if keep is None:
            self.diag.index_copy_(1, self.n_done.reshape(1), values[:, None])
            return
        col = torch.clamp_max(self.n_done, self.diag.shape[-1] - 1).reshape(-1, 1, 1).expand(-1, len(row), 1)
        old = self.diag.gather(-1, col)
        self.diag.scatter_(-1, col, torch.where(keep[:, None, None], values[..., None], old))

    def energies(self, config: PICConfig) -> tuple[torch.Tensor, torch.Tensor]:
        """The state's (field, kinetic) energies (`_energies`); a bucket's
        one a member, each reduced on the member's own tensors, so that it
        sums in the order of the member's solo run."""
        if self.members is None:
            return _energies(self.state(), config)
        per = [_energies(PICState(fields=_member_tree(self.fields, i), particles=_member_tree(self.particles, i),
                                  layout=None, step=0), config) for i in range(self.members)]
        return torch.stack([f for f, _ in per]), torch.stack([k for _, k in per])

    def enter(self, step0: int, fault_vec: torch.Tensor | None, target: int) -> None:
        """The window's start step, fault vector and step target, in one
        copy."""
        fault = fault_vec.tolist() if fault_vec is not None else (FAULT_NONE, -1, 0)
        self._write_entry([step0, *fault, target])


_BUNDLE_HEAD = len(_WindowHead.HEAD)


def _window_step(buf: _WindowBuffers, config: PICConfig, policy: SortPolicyConfig, *, with_energies: bool,
                 health: HealthConfig | None, with_fault: bool, decider) -> None:
    """One step of a window, in place on ``buf``; nothing once the window
    has halted or has made its ``target`` steps. With ``with_fault``, the
    armed fault first corrupts the step's input where it fires. Then the
    step, its sort mode's decision, the step's diagnostics at row
    ``buf.n_done``, and the halt:

    - ``incremental``: the re-sort policy, and the global sort under its
      word or on an overflow; a sort that still overflows halts the window;
    - ``global``: the global sort, every step (not a policy sort); its
      overflow halts the window;
    - ``rebuild``: the step rebuilt the bins; their overflow halts the window;
    - ``none``: nothing.

    The table's rows are the buffers' ``names``: ``n_moved``, ``n_alive``
    and, where named, the energies, ``sorted`` (the step's sort, policy or
    mandatory; every step in ``global``) and ``reason`` (`REASON_OVERFLOW`
    on a mandatory sort, else the policy's code; 0 outside
    ``incremental``), the reference's per-step rows. A row not named is not
    computed.

    With ``health``, the sentinel reads the post-step state; a health halt
    latches its code, its invariant and the values compared, and outranks
    an overflow halt of the same step (a corrupt state rolls back before
    any capacity growth). A halt ends the window's steps, so the first halt
    is the only one, and its step is the window's last.

    Only ``incremental`` touches the policy state. The decisions go to
    ``decider.run_if`` (see `kernels.conditional`: tested on the host, or IF
    nodes of a captured graph).

    An ensemble bucket's buffers (``members=B``) step as the reference's
    vmapped window does: the step runs over every member at once, under
    one guard that some member is active, and each member keeps its new
    state, policy state, counters and diagnostics only where it is active
    (``keep``). The global sort runs over every member under one guard that
    some active member sorts, and is kept by the members that sort. A
    member that is not active comes out bit-unchanged. Buckets run without
    the sentinel and the fault hook."""
    n_slots = config.grid.n_cells * config.capacity
    bucket = buf.members is not None
    if bucket and (health is not None or with_fault):
        raise ValueError("an ensemble bucket's window runs without the health sentinel and fault injection")
    active = ~buf.halted & (buf.n_done < buf.target)
    # the members whose step is kept (a bucket's); None: the single driver's
    # whole step runs under its guard
    keep = active if bucket else None
    named = set(buf.names)

    def kept(flag: torch.Tensor) -> torch.Tensor:
        return flag if keep is None else flag & keep

    def any_of(flag: torch.Tensor) -> torch.Tensor:
        return flag if keep is None else torch.any(flag)

    def commit(state: PICState) -> None:
        """The step's new state into the buffers: a bucket's with the
        members' mask only when some member is not active (a select over
        the whole state runs at a fraction of a copy's rate)."""
        if keep is None:
            buf.store(state)
            return
        everyone = torch.all(keep)
        decider.run_if(everyone, lambda: buf.store(state))
        decider.run_if(~everyone, lambda: buf.store(state, keep))

    def policy_sort(stats: GPMAStats, row: dict) -> None:
        with record_function("pic.policy"):
            if config.needs_bins:
                mandatory = stats.n_overflow > 0
            else:
                mandatory = torch.zeros((), dtype=torch.bool, device=buf.device)
            do_pol, reason, recorded = policy_update(
                buf.pstate, policy, n_moved=stats.n_moved, n_alive=stats.n_alive,
                n_empty=stats.n_empty, n_slots=n_slots,
            )
            do_pol = do_pol & ~mandatory
        _copy_tree(buf.pstate, recorded, keep)
        sorting = kept(do_pol | mandatory)
        if "sorted" in named:
            row["sorted"] = sorting
        if "reason" in named:
            row["reason"] = torch.where(mandatory, REASON_OVERFLOW, reason)

        def sort():
            with record_function("pic.global_sort"):
                state, overflow = global_sort_device(buf.state(), config)
                # a bucket keeps the sort of the members that sort
                mask = None if keep is None else sorting
                buf.store(state, mask)
                _copy_tree(buf.pstate, policy_reset(buf.device), mask)
                buf.halted.logical_or_(overflow > 0 if mask is None else mask & (overflow > 0))

        decider.run_if(any_of(sorting), sort)
        buf.sorts.add_(kept(do_pol).to(torch.int64))
        buf.rebuilds.add_(kept(mandatory).to(torch.int64))

    def step():
        if with_fault:
            buf.store(_apply_fault(buf.state(), buf.step0 + buf.n_done, buf.fault))
        new, stats = _pic_step(buf.state(), config)
        commit(new)
        row = {"n_moved": stats.n_moved, "n_alive": stats.n_alive}
        if named & {"sorted", "reason"} and config.sort_mode != "incremental":  # (the policy's own there)
            row["sorted"] = torch.full(buf.n_done.shape, config.sort_mode == "global", device=buf.device)
            row["reason"] = torch.zeros(buf.n_done.shape, dtype=torch.int32, device=buf.device)
        if config.sort_mode == "incremental":
            policy_sort(stats, row)
        elif config.sort_mode == "global":
            with record_function("pic.global_sort"):
                state, overflow = global_sort_device(buf.state(), config)
                commit(state)
                buf.halted.logical_or_(kept(overflow > 0))
        elif config.sort_mode == "rebuild":
            buf.halted.logical_or_(kept(stats.n_overflow > 0))
        energies = None
        if with_energies or (health is not None and health.check_energy):
            energies = buf.energies(config)
        if with_energies:
            row["field_energy"], row["kinetic_energy"] = energies
        buf.record([row[name] for name in buf.names], keep)

        if health is not None:
            with record_function("pic.sentinel"):
                h_code, *h_info = _sentinel(buf.state(), health, energies, buf.ref_charge, buf.ref_energy)
                bad = h_code != HALT_NONE
                for dst, value in zip((buf.halt_code, buf.halt_inv, buf.halt_meas, buf.halt_ref), (h_code, *h_info)):
                    dst.copy_(torch.where(bad, value, dst))
                buf.halted.logical_or_(bad)
        buf.n_done.add_(1 if keep is None else keep.to(torch.int64))

    decider.run_if(any_of(active), step)


def capture_steps(buf, step) -> tuple[torch.cuda.CUDAGraph, dict]:
    """Capture ``step(buf)``, the window's guarded step, as one CUDA graph,
    after one warm-up step that takes every branch (it brings every lazily
    built library object, such as a BLAS handle, into being before the
    capture). The warm-up runs on ``buf`` itself, not on a copy, so that a
    capture holds no third copy of the state: it leaves the buffers a step
    on, and their owner writes its state back into them after the capture.
    The kernel wrappers count launches when they run, which during a
    capture means once per recorded launch: those counts are taken back and
    returned, for the owner to add once for every replay that ran them."""
    device = buf.device
    torch.cuda.synchronize(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step(buf, decider=EveryBranch())
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    capture = GraphCapture(graph, device)
    before = kernels.launch_counts()
    with capture.capturing():
        step(buf, decider=capture)
    after = kernels.launch_counts()
    launches = {name: after[name] - before[name] for name in after}
    kernels.add_launches(launches, -1)
    torch.cuda.synchronize(device)
    return graph, launches


class Window:
    """One window of a store: its buffers, its step function and, on a CUDA
    device, the captured graph and the kernel launches the step recorded
    into it. ``entry``, if given, is work a window does once at its entry,
    before the steps (captured as a graph of its own). A window refers to
    no caller, so dropping it from its store frees its graphs and
    buffers."""

    def __init__(self, key: tuple, buffers, step, entry=None):
        self.key = key
        self.buffers = buffers
        self.step = step
        self.entry = entry
        self.graph: torch.cuda.CUDAGraph | None = None
        self.entry_graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict = {}
        self.launch_vector: torch.Tensor | None = None

    def capture(self) -> float:
        """Capture the step (`capture_steps`), and the entry work; returns
        the seconds it took. The buffers are left a warm-up step on: the
        owner writes its state into them next. ``launches`` is what a
        replay of the step launches, and ``launch_vector`` the same on the
        device (`kernels.add_launches_later`)."""
        torch.cuda.synchronize(self.buffers.device)
        t0 = time.perf_counter()
        if self.entry is not None:
            self.entry_graph, _ = capture_steps(self.buffers, self.entry)
        self.graph, self.launches = capture_steps(self.buffers, self.step)
        self.launch_vector = kernels.launch_vector(self.launches, self.buffers.device)
        return time.perf_counter() - t0

    def run(self, k: int, read=None) -> None:
        """The entry work, then k guarded steps: replays of the graphs, or
        on the CPU the same functions run eagerly, deciding on the host
        (``read`` moves a device predicate to the host)."""
        if self.graph is not None:
            if self.entry_graph is not None:
                self.entry_graph.replay()
            for _ in range(k):
                self.graph.replay()
            return
        decider = HostDecider(read)
        if self.entry is not None:
            self.entry(self.buffers, decider=decider)
        for _ in range(k):
            self.step(self.buffers, decider=decider)


class WindowStore:
    """The captured windows of one functional face, the counterpart of a
    jitted function's executable cache: the ``SLOTS`` most recently used
    windows by key (a service's callable keeps one a batch size). A new
    window first frees the least recently used one that it would push out.
    ``builds``, ``captures`` and ``setup_seconds`` count the windows built,
    captured, and the seconds their capture took; ``last`` is the window of
    the last call."""

    SLOTS = 4

    def __init__(self):
        self.store: OrderedDict[tuple, Window] = OrderedDict()
        self.builds = 0
        self.captures = 0
        self.setup_seconds = 0.0
        self.last: Window | None = None

    def window(self, key: tuple, build) -> Window:
        """The window of ``key``: the store's, or ``build()``'s, captured on
        a CUDA device. A failed capture raises; nothing falls back to an
        eager loop."""
        w = self.store.get(key)
        if w is None:
            while len(self.store) >= self.SLOTS:
                self.discard(next(iter(self.store.values())))
            w = build()
            self.builds += 1
            if w.buffers.device.type == "cuda":
                self.setup_seconds += w.capture()
                self.captures += 1
            self.store[key] = w
        else:
            self.store.move_to_end(key)
        self.last = w
        return w

    def discard(self, window: Window | None) -> None:
        """Drop ``window`` from the store, freeing its graphs and buffers."""
        if window is not None and self.store.get(window.key) is window:
            del self.store[window.key]
        if self.last is window:
            self.last = None

    def clear(self) -> None:
        self.store.clear()
        self.last = None


def parse_bundle(host: np.ndarray, names: tuple[str, ...], k: int, step0: int) -> dict:
    """A window's bundle row (`_WindowBuffers.bundle`), read on the host, as
    the drivers' bundle dict. A halted window's last step is the halting
    one; a halt without the sentinel's code is an overflow."""
    n_done = int(host[0])
    halted = bool(host[1])
    return {
        "n_done": n_done,
        "n_sorts": int(host[2]),
        "n_rebuilds": int(host[3]),
        "halt_code": int(host[4]) or (HALT_BIN_OVERFLOW if halted else HALT_NONE),
        "halt_step": step0 + n_done if halted else -1,
        "halt_inv": int(host[5]),
        "halt_measured": float(host[6]),
        "halt_reference": float(host[7]),
        "per_step": dict(zip(names, host[_BUNDLE_HEAD:].reshape(len(names), k))),
    }


def consume_window_bundle(host: dict, host_step: int, diagnostics_every: int, history: list) -> tuple[int, int, int]:
    """The per-window accounting both drivers share: append the window's
    diagnostics records (every ``diagnostics_every`` absolute steps after
    ``host_step``) to ``history``; return (n_done, n_sorts, n_rebuilds)."""
    n_done = host["n_done"]
    if diagnostics_every:
        per = host["per_step"]
        for i in range(n_done):
            step_abs = host_step + i + 1
            if step_abs % diagnostics_every == 0:
                fe = float(per["field_energy"][i])
                ke = float(per["kinetic_energy"][i])
                history.append({
                    "step": step_abs,
                    "field_energy": fe,
                    "kinetic_energy": ke,
                    "total_energy": fe + ke,
                    "n_alive": int(per["n_alive"][i]),
                    "n_moved": int(per["n_moved"][i]),
                })
    return n_done, host["n_sorts"], host["n_rebuilds"]


UNSET = object()

#: the warning a driver built directly, without a spec, gives (the
#: reference's message, with the port's names)
DEPRECATION_MSG = (
    "{cls}(fields, particles, config) is deprecated: describe the run as a repro_torch.api.SimSpec (scenario "
    "registry: repro_torch.api.scenario) and build the driver with repro_torch.api.make_simulation(spec). The "
    "direct constructor builds the same driver and keeps working, but a spec-built driver also carries run "
    "defaults, provenance and the metadata a checkpoint rebuilds it from."
)


def resolve_run_args(spec, n_steps, diagnostics_every, window, autosave_every=None, autosave_path=None):
    """`Simulation.run`'s arguments against the driver's spec (None or
    UNSET: the spec's value; a spec-less driver keeps the historical
    defaults). ``autosave_every=N`` with no path saves under
    ``checkpoints/<spec.name>``; autosave needs the windowed driver."""
    run = None if spec is None else spec.run
    if n_steps is None:
        if run is None:
            raise TypeError("run() needs n_steps (this driver has no spec defaults)")
        n_steps = run.steps
    if diagnostics_every is None:
        diagnostics_every = 0 if run is None else run.diagnostics_every
    if window is UNSET:
        window = None if run is None else (run.window or None)
    if autosave_every is None:
        autosave_every = 0 if run is None else run.autosave_every
    if autosave_path is None:
        autosave_path = "" if run is None else run.autosave_path
    if autosave_every and not autosave_path:
        autosave_path = os.path.join("checkpoints", getattr(spec, "name", None) or "sim")
    if autosave_every and window is None:
        raise ValueError("autosave_every requires the windowed driver (window=K)")
    return n_steps, diagnostics_every, window, autosave_every, autosave_path


def _trees(state: PICState, pstate: SortPolicyState) -> list:
    """The tensor trees of a window's state: fields, particles, layout,
    policy state and, when the step carries one, the slab."""
    return [state.fields, state.particles, state.layout, pstate] + ([] if state.slab is None else [state.slab])


def _same_shapes(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        type(x) is type(y) and all(getattr(x, f.name).shape == getattr(y, f.name).shape
                                   for f in dataclasses.fields(x))
        for x, y in zip(a, b))


class Simulation:
    """Single-device driver: step, re-sort policy, global sort on the
    policy's word, capacity growth on a persistent overflow, and the fault
    supervisor's rollback, remedy ladder and autosave.

    Build it with `repro_torch.api.make_simulation(spec)` (built directly,
    with no spec, it warns `DeprecationWarning`, as the reference's); the
    state's tensors decide the device. ``run(n, window=K)`` runs windows: on a CUDA
    device each window replays one captured CUDA graph of the step, with
    the sort decision and the window's halt as IF nodes (``use_graphs``,
    default on for CUDA); the state's tensors are then the graph's, updated
    in place. ``run(n, window=None)`` runs the host-driven loop, with its
    own policy counters (``host_policy``), as in the reference: pick one
    driver per simulation. The health sentinel, the remedy ladder and
    autosave apply to the windowed driver.
    """

    def __init__(self, fields: FieldState, particles: ParticleState, config: PICConfig,
                 policy: SortPolicyConfig | None = None, *, spec=None):
        if spec is None:
            warnings.warn(DEPRECATION_MSG.format(cls="Simulation"), DeprecationWarning, stacklevel=2)
        self.spec = spec
        self.config = config
        state, overflow = init_state(fields, particles, config)
        if overflow:
            self.config = dataclasses.replace(config, capacity=choose_capacity(config.capacity * 2 // 3 * 2))
            state, overflow = init_state(fields, particles, self.config)
            assert overflow == 0, "initial binning overflow after capacity growth"
        self.device = particles.pos.device
        self.policy = policy or SortPolicyConfig()
        self.host_policy = ResortPolicy(self.policy)
        self.state = state
        self.policy_state = policy_init(self.device)
        self._prewarm_dispatch()
        self.use_graphs = self.device.type == "cuda"
        self.sorts = 0
        self.rebuilds = 0
        self.history: list[dict] = []
        self.halts: dict[str, int] = {}
        self.growths = {"capacity": 0}
        self.windows = 0
        self.host_reads = 0
        #: CUDA graphs captured, and the seconds their set-up took (warm-up
        #: step, capture, instantiation), both included in `run`
        self.graph_captures = 0
        self.graph_setup_seconds = 0.0
        self._host_step = 0
        # fault tolerance: the supervisor's counters, the sentinel's
        # configuration, the chaos harness's injector and the rollback
        # snapshot's buffers
        self.retries = 0
        self.restarts = 0
        self.discarded_steps = 0
        self._remedy_level = 0
        self._health = spec.health if (spec is not None and spec.health.enable) else None
        self.fault_injector = PICFaultInjector(spec.fault) if (spec is not None and spec.fault is not None) else None
        self._snapshot: dict | None = None

    # -- state: assigning it drops the window's buffers and graph ----------

    @property
    def state(self) -> PICState:
        return self._state

    @state.setter
    def state(self, value: PICState) -> None:
        self._state = value
        self._window = None

    @property
    def policy_state(self) -> SortPolicyState:
        return self._policy_state

    @policy_state.setter
    def policy_state(self, value: SortPolicyState) -> None:
        self._policy_state = value
        self._window = None

    def _install(self, state: PICState, pstate: SortPolicyState) -> None:
        """Make (state, pstate), of the current shapes, the driver's: copied
        into the window's buffers when there is a window (its captured step
        stays valid), else assigned."""
        if self._window is None:
            self.state, self.policy_state = state, pstate
            return
        buf = self._window.buffers
        buf.store(state)
        _copy_tree(buf.pstate, pstate)
        self._state = buf.state(state.step)

    # -- host reads ---------------------------------------------------------

    def _read(self, tensor: torch.Tensor):
        """Every device-to-host read of a run goes through here."""
        self.host_reads += 1
        return tensor.cpu()

    def run(self, n_steps: int | None = None, *, diagnostics_every: int | None = None, window=UNSET,
            autosave_every: int | None = None, autosave_path: str | None = None) -> None:
        """Advance `n_steps` (default: the spec's) in windows of `window`
        steps (default: the spec's; a spec's ``run.window == 0`` and a
        spec-less driver mean None), or with ``window=None`` in the
        host-driven loop. ``autosave_every=N`` checkpoints the windowed run
        every N steps (and at its start and end) under ``autosave_path``,
        and an exception restores the latest checkpoint and resumes."""
        n_steps, diagnostics_every, window, autosave_every, autosave_path = resolve_run_args(
            self.spec, n_steps, diagnostics_every, window, autosave_every, autosave_path)
        if window is None:
            self._run_host(n_steps, diagnostics_every)
            return
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        run_supervised_windows(self, n_steps, diagnostics_every, window, autosave_every=autosave_every,
                               autosave_path=autosave_path)

    def save(self, path: str) -> None:
        """Checkpoint to `path` in the reference's format (see
        `repro_torch.checkpoint.save_simulation`)."""
        from repro_torch.checkpoint import save_simulation

        save_simulation(self, path)

    def restore(self, path: str) -> None:
        """Restore a checkpoint of a compatible run, written by either
        package (see `repro_torch.checkpoint.restore_simulation`)."""
        from repro_torch.checkpoint import restore_simulation

        restore_simulation(self, path)

    # -- the host-driven loop -------------------------------------------------

    def _run_host(self, n_steps: int, diagnostics_every: int) -> None:
        """One eager step per iteration, its statistics read on the host
        and `host_policy` deciding, as the reference's `_run_host`: about
        three host reads a step in ``incremental``."""
        for _ in range(n_steps):
            t0 = time.perf_counter()
            self.state, stats = _pic_step(self.state, self.config)
            self._host_step += 1
            mode = self.config.sort_mode
            if mode == "incremental":
                n_overflow = int(self._read(stats.n_overflow))
                n_empty = int(self._read(stats.n_empty))
                n_slots = self.config.grid.n_cells * self.config.capacity
                if self.config.needs_bins and n_overflow > 0:
                    self._host_sort()  # the mandatory rebuild
                    self.rebuilds += 1
                    self.host_policy.reset()
                else:
                    dt = time.perf_counter() - t0
                    perf = float(int(self._read(stats.n_alive))) / max(dt, 1e-9)
                    self.host_policy.record_step(rebuilt=False, perf=perf)
                    do, _reason = self.host_policy.should_sort(empty_ratio=n_empty / max(n_slots, 1))
                    if do:
                        self._host_sort()
                        self.sorts += 1
                        self.host_policy.reset()
            elif mode == "global":
                self._host_sort()
            elif mode == "rebuild" and int(self._read(stats.n_overflow)) > 0:
                self._grow_capacity()
            if diagnostics_every and self._host_step % diagnostics_every == 0:
                self.history.append(self._diagnostics(self._read))

    def _host_sort(self) -> None:
        """The global sort, its overflow read on the host; a capacity growth
        when it persists."""
        self.state, overflow = global_sort_device(self.state, self.config)
        if int(self._read(overflow)):
            self._grow_capacity()

    # -- the windowed driver ------------------------------------------------

    def _window_for(self, with_energies: bool, n_diag: int) -> Window:
        """The window's buffers and, on CUDA with ``use_graphs``, its
        captured step; made anew when the configuration, the diagnostics,
        the sentinel or the state's shapes change. A driver with a fault
        spec captures the injection into every window (an unarmed window's
        vector never fires), so that arming a fault never recaptures."""
        names = ("n_moved", "n_alive") + (("field_energy", "kinetic_energy") if with_energies else ())
        with_fault = self.fault_injector is not None
        key = (self.config, self.policy, names, n_diag, self.use_graphs, self._health, with_fault)
        if self._window is not None and self._window.key == key:
            return self._window
        buf = _WindowBuffers(self._state, self._policy_state, names, n_diag)
        # (no closure over the driver: the window must not keep it alive)
        w = Window(key, buf, functools.partial(_window_step, config=self.config, policy=self.policy,
                                               with_energies=with_energies, health=self._health,
                                               with_fault=with_fault))
        if self.use_graphs:
            self.graph_setup_seconds += w.capture()
            self.graph_captures += 1
            # the capture's warm-up step ran on the buffers: the state back in
            buf.store(self._state)
            _copy_tree(buf.pstate, self._policy_state)
        self._window = w
        self._state, self._policy_state = buf.state(self._state.step), buf.pstate
        return w

    def _run_window(self, k: int, *, with_energies: bool, n_diag: int, fault_vec=None) -> dict:
        """Up to k <= n_diag steps; stops after a step that halts. Returns
        the window's host bundle (one read)."""
        w = self._window_for(with_energies, n_diag)
        buf = w.buffers
        buf.reset_counters()
        step0 = self._state.step
        buf.enter(step0, fault_vec, k)
        if self._health is not None:
            # the sentinel's references, from the state the window starts at
            fe, ke = _energies(self._state, self.config)
            buf.ref_charge.copy_(_total_charge(self._state))
            buf.ref_energy.copy_(fe + ke)
        w.run(k, self._read)
        self.windows += 1
        # the window's one bundle read
        host = parse_bundle(self._read(buf.bundle(k)).numpy(), buf.names, k, step0)
        if w.graph is not None:
            kernels.add_launches(w.launches, host["n_done"])
        self._state = buf.state(step0 + host["n_done"])
        return host

    # -- the supervisor's hooks (distributed.fault.run_supervised_windows) ---

    def _enter_window(self, k: int, window: int, diagnostics_every: int, fault_vec) -> dict:
        """One window of k steps (its table sized for ``window``), and its
        bundle: the window's one device-to-host read."""
        return self._run_window(k, with_energies=bool(diagnostics_every), n_diag=window, fault_vec=fault_vec)

    def _consume_bundle(self, host: dict, diagnostics_every: int) -> int:
        """Commit a window that did not halt on health: its diagnostics and
        counters."""
        n_done, n_sorts, n_rebuilds = consume_window_bundle(host, self._host_step, diagnostics_every, self.history)
        self.sorts += n_sorts
        self.rebuilds += n_rebuilds
        self._host_step += n_done
        return n_done

    def _take_snapshot(self) -> dict:
        """The window's entry state (fields, particles, layout, policy state,
        slab and step), copied on the device into buffers of the driver's
        own, made once for each set of shapes."""
        trees = _trees(self._state, self._policy_state)
        snap = self._snapshot
        if snap is None or not _same_shapes(snap["trees"], trees):
            snap = self._snapshot = {"trees": [_clone_tree(t) for t in trees]}
        else:
            for dst, src in zip(snap["trees"], trees):
                _copy_tree(dst, src)
        snap["step"] = self._state.step
        return snap

    def _restore_snapshot(self, snap: dict) -> None:
        """Roll back to a snapshot, in place in the window's buffers: the
        captured step stays valid and is replayed as it is."""
        fields, particles, layout, pstate, *slab = snap["trees"]
        self._install(PICState(fields=fields, particles=particles, layout=layout, step=snap["step"],
                               slab=slab[0] if slab else None), pstate)

    def _handle_halt(self, code: int, host: dict) -> None:
        if code == HALT_BIN_OVERFLOW:
            self._grow_capacity()
        else:
            raise RuntimeError(f"single-device driver cannot handle halt code {code} ({HALT_NAMES[code]})")

    def _remedy_sort(self) -> None:
        """The ladder's second rung: a forced global sort (fresh bins, the
        attributes permuted) and a reset of the device policy state."""
        state, overflow = global_sort_device(self.state, self.config)
        self._install(state, policy_init(self.device))
        if int(self._read(overflow)):
            self._grow_capacity()

    def _demote_backend(self) -> bool:
        """The ladder's last rungs: the kernel backend one step down the
        dispatcher's priority ladder (``cuda_reduced`` -> ``cuda`` ->
        ``torch``). False when already at the bottom. `dispatch.demote`
        answers from the memo or the cache, never running the kernels
        suspected of the halt."""
        nxt = dispatch.demote(self.config.backend, device=self.device, order=self.config.order,
                              grid_shape=self.config.grid.shape, capacity=self.config.capacity,
                              dtype=self.state.particles.pos.dtype)
        if nxt is None:
            return False
        self.config = dataclasses.replace(self.config, backend=nxt)
        return True

    def _prewarm_dispatch(self) -> None:
        """Resolve the config's ``auto`` dispatch keys eagerly (timed and
        cached on first sight), so that the captured step finds the winner
        in the memo. Run again after anything that changes a key: a capacity
        growth, a checkpoint restore. A timing runs on a slab at the state's
        mean occupancy, read here once (a set-up read, like the timing's
        own, outside `host_reads`)."""
        prewarm_dispatch(self.config, self.state.particles)

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
        self._prewarm_dispatch()  # the capacity is part of the dispatch key

    # -- diagnostics --------------------------------------------------------

    def diagnostics(self) -> dict:
        return self._diagnostics(torch.Tensor.cpu)

    def _diagnostics(self, read) -> dict:
        """Step, energies and live particles of the current state, in one
        read through ``read``."""
        s = self.state
        field_e, kinetic_e = _energies(s, self.config)
        host = read(torch.stack([field_e.to(torch.float64), kinetic_e.to(torch.float64),
                                 torch.sum(s.particles.alive).to(torch.float64)]))
        em, kinetic = float(host[0]), float(host[1])
        return {
            "step": s.step,
            "field_energy": em,
            "kinetic_energy": kinetic,
            "total_energy": em + kinetic,
            "n_alive": int(host[2]),
        }


def prewarm_dispatch(config: PICConfig, particles: ParticleState, *, batch: int = 1) -> None:
    """Resolve ``config``'s ``auto`` dispatch keys eagerly (timed and cached
    on first sight), so that a captured step finds the winner in the memo;
    at ``batch`` = the member count for an ensemble bucket's step, whose
    ``particles`` carry the member axis. A timing runs on a slab at the
    particles' mean occupancy, read here once (a set-up read)."""
    if config.backend != "auto":
        return
    fill = -(-int(torch.count_nonzero(particles.alive)) // (batch * config.grid.n_cells))
    dispatch.prewarm(dispatch.ops_for_modes(config.deposition, config.gather), device=particles.pos.device,
                     order=config.order, grid_shape=config.grid.shape, capacity=config.capacity,
                     dtype=particles.pos.dtype, fill=fill, batch=batch)


# -- the functional faces -----------------------------------------------------------

#: the per-step rows of a functional window's bundle, the reference's
#: ``per_step`` keys
PER_STEP_NAMES = ("active", "sorted", "reason", "n_moved", "n_alive", "field_energy", "kinetic_energy")


def _shapes(trees: list) -> tuple:
    return tuple((f.name, tuple(getattr(t, f.name).shape), getattr(t, f.name).dtype)
                 for t in trees for f in dataclasses.fields(t))


def _on_device(value) -> bool:
    return isinstance(value, torch.Tensor) and value.device.type != "cpu"


def enter_entry(buf, columns: dict) -> None:
    """Write a functional window's entry vector: ``columns`` maps a column
    (an index or a slice of ``buf.entry``'s last axis) to its value. Host
    values (ints, numpy arrays, CPU tensors) go in one asynchronous copy;
    CUDA tensors are copied on the device after it, so nothing is read
    back."""
    host = buf.entry.new_zeros(buf.entry.shape, device="cpu")
    host[..., 1:4] = torch.tensor([FAULT_NONE, -1, 0])
    later = []
    for col, value in columns.items():
        if value is None:
            continue
        if _on_device(value):
            later.append((col, value))
        else:
            host[..., col] = torch.as_tensor(np.asarray(value), dtype=torch.int64)
    buf._write_entry(host)
    for col, value in later:
        buf.entry[..., col].copy_(value)


def window_bundle(buf: _WindowBuffers, n_steps: int, with_energies: bool, step_after: torch.Tensor) -> dict:
    """A functional window's bundle, every leaf a fresh device tensor (a
    member axis first on each, for a bucket): the reference's keys, its
    halt code and halt step computed on the device. A halt without the
    sentinel's code is an overflow; the per-step rows are zero past
    ``n_done``."""
    i32 = torch.int32
    n_done = buf.n_done.to(i32)
    code = torch.where(buf.halt_code != HALT_NONE, buf.halt_code, buf.halted.to(i32) * HALT_BIN_OVERFLOW)
    active = torch.arange(n_steps, device=buf.device) < n_done[..., None]
    table = torch.where(active[..., None, :], buf.diag, 0.0)

    def row(name, dtype):
        if name not in buf.names:
            return torch.zeros(active.shape, dtype=dtype, device=buf.device)
        return table[..., buf.names.index(name), :].to(dtype)

    per_step = {"active": active}
    for name, dtype in zip(PER_STEP_NAMES[1:], (torch.bool, i32, i32, i32, torch.float32, torch.float32)):
        per_step[name] = row(name, dtype)
    return {
        "n_done": n_done,
        "n_sorts": buf.sorts.to(i32),
        "n_rebuilds": buf.rebuilds.to(i32),
        "overflow_pending": code == HALT_BIN_OVERFLOW,
        "halt_code": code,
        "halt_step": torch.where(buf.halted, step_after, torch.full_like(step_after, -1)),
        "halt_inv": buf.halt_inv.clone(),
        "halt_measured": buf.halt_meas.clone(),
        "halt_reference": buf.halt_ref.clone(),
        "per_step": per_step,
    }


def bundle_to_host(bundle: dict, read=torch.Tensor.cpu) -> dict:
    """A device bundle (a dict of tensors, nested one level) on the host as
    numpy arrays of the same dtypes, in one read through ``read``."""
    flat = [(k, v) for k, v in bundle.items() if k != "per_step"] + \
        [(("per_step", k), v) for k, v in bundle.get("per_step", {}).items()]
    packed = read(torch.cat([v.reshape(-1).to(torch.float64) for _, v in flat])).numpy()
    out, at = {"per_step": {}}, 0
    for k, v in flat:
        part = packed[at:at + v.numel()].reshape(tuple(v.shape)).astype(str(v.dtype).removeprefix("torch."))
        at += v.numel()
        if isinstance(k, tuple):
            out["per_step"][k[1]] = part
        else:
            out[k] = part
    return out


class WindowFn(WindowStore):
    """A functional window: a callable with the signature of
    `pic_run_window` (``members=False``) or `ensemble_run_window`
    (``members=True``) and a store of captured windows of its own
    (`WindowStore`), keyed by the static arguments (config, policy,
    ``n_steps``, the per-step rows, the sentinel, whether a fault vector is
    armed), the shapes of the state and its device.

    On a CUDA device a window is one captured graph of the guarded step,
    replayed ``n_steps`` times; on the CPU the same step runs eagerly,
    deciding on the host. A call copies the caller's state into the
    window's own buffers, runs, and hands the result back:

    * with ``donate=False`` in fresh tensors, the caller's left as they
      were;
    * with ``donate=True`` in the caller's own tensors (the counterpart of
      the reference's donated buffers), which come back.

    Either way no later call writes a tensor it returned unless it is
    passed back with ``donate=True``. The state's ``step`` (an int, a numpy
    array a member, or a device tensor) and ``n_target`` may come from the
    device: a call on a window already built makes no device-to-host read
    and captures nothing. The launches of a window's kernels are counted
    when the counts are next read (`kernels.add_launches_later`).

    Where the state passed in is the window's own buffers (an ensemble
    bucket's, which holds them as its state, as `Simulation` holds its
    window's), nothing is copied in, and with ``donate=True`` nothing out:
    the window runs on them in place, which is a donation, so it is meant
    with ``donate=True`` only."""

    def __init__(self, *, members: bool = False, donate: bool = True):
        super().__init__()
        self.members = members
        self.donate = donate

    def __call__(self, state: PICState, policy_state: SortPolicyState, config: PICConfig, n_steps: int, *,
                 policy: SortPolicyConfig | None = None, with_energies: bool = True, donate: bool | None = None,
                 n_target=None, health: HealthConfig | None = None, fault_vec=None):
        policy = policy or SortPolicyConfig()
        donate = self.donate if donate is None else donate
        n_steps = int(n_steps)
        if n_steps <= 0:
            raise ValueError(f"n_steps must be positive, got {n_steps}")
        members = int(state.particles.pos.shape[0]) if self.members else None
        if self.members and (health is not None or fault_vec is not None):
            raise ValueError("ensemble_run_window runs without the health sentinel and fault injection: "
                             f"health={health!r}, fault_vec={fault_vec!r} (the reference's ensemble driver passes "
                             "neither)")
        trees = _trees(state, policy_state)
        names = ("sorted", "reason", "n_moved", "n_alive") + (("field_energy", "kinetic_energy")
                                                              if with_energies else ())
        with_fault = fault_vec is not None
        key = (config, policy, n_steps, names, health, with_fault, members, str(state.particles.pos.device),
               _shapes(trees))

        def build() -> Window:
            prewarm_dispatch(config, state.particles, batch=members or 1)
            buf = _WindowBuffers(state, policy_state, names, n_steps, members=members)
            return Window(key, buf, functools.partial(_window_step, config=config, policy=policy,
                                                      with_energies=with_energies, health=health,
                                                      with_fault=with_fault))

        w = self.window(key, build)
        buf = w.buffers
        for dst, src in zip(_trees(buf.state(), buf.pstate), trees):
            _copy_tree(dst, src)  # (nothing where src is the buffers)
        buf.reset_counters()
        enter_entry(buf, {0: state.step, slice(1, 4): fault_vec, 4: n_steps if n_target is None else n_target})
        if health is not None:
            # the sentinel's references, from the state the window starts at
            fe, ke = _energies(buf.state(), config)
            buf.ref_charge.copy_(_total_charge(buf.state()))
            buf.ref_energy.copy_(fe + ke)
        w.run(n_steps)
        step_after = (buf.step0 + buf.n_done).to(torch.int32)
        bundle = window_bundle(buf, n_steps, with_energies, step_after)
        if w.graph is not None:
            # the step ran while some member was active: max_i n_done_i times
            kernels.add_launches_later(w.launch_vector, buf.n_done if members is None else buf.n_done.max())
        if donate:
            for dst, src in zip(trees, _trees(buf.state(), buf.pstate)):
                _copy_tree(dst, src)
            return dataclasses.replace(state, step=step_after), policy_state, bundle
        out = PICState(fields=_clone_tree(buf.fields), particles=_clone_tree(buf.particles),
                       layout=_clone_tree(buf.layout), step=step_after,
                       slab=None if buf.slab is None else _clone_tree(buf.slab))
        return out, _clone_tree(buf.pstate), bundle


class _SharedWindowFn(WindowFn):
    """The store behind `pic_run_window` and `ensemble_run_window`: only
    the window of the latest call, so that a window (its buffers a clone of
    a whole state, its graph's pool) does not outlive the next call with
    other shapes or statics. `clear_windows` frees it."""

    SLOTS = 1


_PIC_WINDOWS = _SharedWindowFn()
_ENSEMBLE_WINDOWS = _SharedWindowFn(members=True)


def pic_run_window(state: PICState, policy_state: SortPolicyState, config: PICConfig, n_steps: int, *,
                   policy: SortPolicyConfig | None = None, with_energies: bool = True, donate: bool = True,
                   n_target=None, health: HealthConfig | None = None, fault_vec=None):
    """Run a window of ``n_steps`` steps on the device: the step, the sort
    mode's decision, the sentinel and the per-step diagnostics, with no
    host read (`WindowFn`). Counterpart of `repro.pic.simulation.
    pic_run_window`.

    ``n_steps`` sets the window's length (and its captured graph); steps
    from ``n_target`` on (an int, a 0-d tensor, None for ``n_steps``), and
    after a step that halts, do nothing. ``health`` runs the sentinel
    against references taken at entry; ``fault_vec`` (kind, step,
    component) arms the chaos harness's injection at the absolute step
    ``state.step + i``. ``donate=False`` leaves the input tensors as they
    were.

    Returns ``(state, policy_state, bundle)``, all on the device: the
    state's ``step`` a 0-d int32 tensor; the bundle with ``n_done``,
    ``n_sorts``, ``n_rebuilds``, ``overflow_pending``, ``halt_code``,
    ``halt_step``, ``halt_inv``, ``halt_measured``, ``halt_reference`` and
    ``per_step``, (n_steps,) rows of `PER_STEP_NAMES` (the energies zero
    without ``with_energies``). `bundle_to_host` reads it in one read. A
    halt on an overflow asks the host to grow the capacity and re-enter."""
    return _PIC_WINDOWS(state, policy_state, config, n_steps, policy=policy, with_energies=with_energies,
                        donate=donate, n_target=n_target, health=health, fault_vec=fault_vec)


def ensemble_run_window(state: PICState, policy_state: SortPolicyState, config: PICConfig, n_steps: int, *,
                        policy: SortPolicyConfig | None = None, with_energies: bool = True, donate: bool = True,
                        n_target=None, health: HealthConfig | None = None, fault_vec=None):
    """`pic_run_window` for every member of a stacked ensemble state
    (`pic.ensemble.stack_trees`): one step over the member axis, each
    kernel launched once for every member, each member kept only while it
    is active. ``n_target`` gives each member's step count (``[B]``; None
    runs every member ``n_steps``); a member with target 0 comes back
    bit-unchanged. Every bundle leaf carries the member axis: ``halt_code``
    is ``[B]``, the ``per_step`` rows ``(B, n_steps)``. The dispatcher's
    keys are resolved at ``batch`` = B before the first capture (the port's
    `PICConfig` has no ``dispatch_batch``: B is the leading axis). The
    sentinel and the fault hook are refused, as the reference's ensemble
    driver passes neither. Counterpart of `repro.pic.simulation.
    ensemble_run_window`."""
    return _ENSEMBLE_WINDOWS(state, policy_state, config, n_steps, policy=policy, with_energies=with_energies,
                             donate=donate, n_target=n_target, health=health, fault_vec=fault_vec)


def clear_windows() -> None:
    """Free the windows `pic_run_window` and `ensemble_run_window` keep
    (each the latest call's): their buffers and captured graphs. Call it
    between runs of different configurations, so that one run's memory
    reading holds nothing of another's."""
    _PIC_WINDOWS.clear()
    _ENSEMBLE_WINDOWS.clear()

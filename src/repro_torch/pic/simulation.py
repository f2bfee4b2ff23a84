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

`Simulation.host_reads` counts every device-to-host read a run makes: one
per window, two more per capacity growth; about three a step in the
host-driven loop. `Simulation.save` and `Simulation.restore` write and read
the reference's checkpoint format (`repro_torch.checkpoint`).
"""

from __future__ import annotations

import dataclasses
import time

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
from repro_torch.core.deposition import (
    CURRENT_STAGGER,
    deposit_current_matrix_fused,
    deposit_matrix,
    deposit_rhocell,
    deposit_scatter,
)
from repro_torch.core.gather import EB_STAGGERS, gather_fields_fused, gather_matrix, gather_scatter
from repro_torch.core.gpma import GPMAStats, gpma_update
from repro_torch.core.resort_policy import (
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
from repro_torch.kernels.conditional import EveryBranch, GraphCapture, HostDecider
from repro_torch.pic.grid import FieldState, GridSpec
from repro_torch.pic.maxwell import maxwell_step
from repro_torch.pic.plasma import ParticleState
from repro_torch.pic.pusher import advance_positions, boris_push, lorentz_gamma, wrap_periodic

# halt codes of the windowed driver (the first two of repro.core.health's)
HALT_NONE = 0
HALT_BIN_OVERFLOW = 1
HALT_NAMES = ("none", "bin_overflow")


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
    guard-padded: (6, nx+2g, ny+2g, nz+2g)."""
    return unfold_guards(torch.stack(fields.all()), guard, dims=(1, 2, 3)).contiguous()


def _gather_fields(pos, fields: FieldState, layout: BinnedLayout, slab: BinSlab | None, config: PICConfig):
    """E and B at the particles, (Np, 3) each, by the configured gather."""
    shape, order = config.grid.shape, config.order
    padded = padded_fields(fields, config.guard)
    if config.gather == "matrix":
        return gather_fields_fused(slab, padded, layout, grid_shape=shape, order=order, backend=config.backend)
    comps = []
    for k, stagger in enumerate(EB_STAGGERS):
        if config.gather == "matrix_unfused":
            comps.append(gather_matrix(pos, padded[k], layout, grid_shape=shape, order=order, stagger=stagger,
                                       backend=config.backend))
        else:
            comps.append(gather_scatter(pos, padded[k], order=order, stagger=stagger))
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
        values = qw * v[:, k]
        if config.deposition == "scatter":
            j = deposit_scatter(pos, values, grid_shape=shape, order=order, stagger=stagger)
        elif config.deposition == "rhocell":
            j = deposit_rhocell(pos, values, cells, grid_shape=shape, order=order, stagger=stagger)
        else:
            j = deposit_matrix(pos, values, layout, grid_shape=shape, order=order, stagger=stagger,
                               backend=config.backend)
        out.append(fold_guards(j, config.guard) * inv_vol)
    return out


def _pic_step(state: PICState, config: PICConfig) -> tuple[PICState, GPMAStats]:
    """One simulation step. Each phase is a `record_function` range
    (``pic.gather`` ... ``pic.maxwell``), so a profiler run attributes the
    device time to the step's layers; without a profiler a range costs a
    few microseconds of host time."""
    p = state.particles
    shape = config.grid.shape
    alive_f = p.alive.to(p.pos.dtype)

    # 1. field gather (bins and the carried slab are current with respect
    #    to the pre-push positions)
    with record_function("pic.gather"):
        e_p, b_p = _gather_fields(p.pos, state.fields, state.layout, state.slab, config)

    # 2. push
    with record_function("pic.push"):
        alive_col = p.alive[:, None]
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
            stats = GPMAStats(n_moved=torch.sum(new_cells != cell_index(p.pos, shape)), n_overflow=overflow,
                              n_empty=layout.n_empty(), n_alive=torch.sum(p.alive))
        else:  # none: the layout stays as it is
            layout = state.layout
            zero = torch.zeros((), dtype=torch.int64, device=p.pos.device)
            stats = GPMAStats(n_moved=zero, n_overflow=zero, n_empty=zero, n_alive=torch.sum(p.alive))

    # 4. the step's one slab staging (the fused deposition stages positions
    #    and q·w·v together), then deposition at x^{n+1}, v^{n+1/2}
    particles = dataclasses.replace(p, pos=pos_new, u=u_new)
    with record_function("pic.staging"):
        gamma = lorentz_gamma(u_new)
        v = u_new / gamma[:, None]
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


# -- the window in place --------------------------------------------------------


def _clone_tree(tree):
    """A dataclass of tensors with every tensor cloned."""
    return dataclasses.replace(tree, **{f.name: getattr(tree, f.name).clone() for f in dataclasses.fields(tree)})


def _copy_tree(dst, src) -> None:
    """Write every tensor of ``src`` into the same-named tensor of ``dst``."""
    for f in dataclasses.fields(dst):
        d, s = getattr(dst, f.name), getattr(src, f.name)
        if d is not s:
            d.copy_(s)


class _WindowBuffers:
    """The window's state held in place: the tensors a step reads and then
    overwrites, the policy state, the window's counters and its per-step
    diagnostics table. On the card they are the captured graph's inputs and
    outputs, at fixed addresses; the step function is the same everywhere."""

    def __init__(self, state: PICState, pstate: SortPolicyState, names: tuple[str, ...], n_diag: int):
        dev = state.particles.pos.device
        self.device = dev
        self.fields = _clone_tree(state.fields)
        self.particles = _clone_tree(state.particles)
        self.layout = _clone_tree(state.layout)
        self.slab = None if state.slab is None else _clone_tree(state.slab)
        self.pstate = _clone_tree(pstate)
        self.names = names
        self.diag = torch.zeros((len(names), n_diag), dtype=torch.float64, device=dev)
        self.n_done = torch.zeros((), dtype=torch.int64, device=dev)
        self.halted = torch.zeros((), dtype=torch.bool, device=dev)
        self.sorts = torch.zeros((), dtype=torch.int64, device=dev)
        self.rebuilds = torch.zeros((), dtype=torch.int64, device=dev)

    def state(self, step: int = 0) -> PICState:
        return PICState(fields=self.fields, particles=self.particles, layout=self.layout, step=step, slab=self.slab)

    def store(self, state: PICState) -> None:
        _copy_tree(self.fields, state.fields)
        _copy_tree(self.particles, state.particles)
        _copy_tree(self.layout, state.layout)
        if self.slab is not None:
            _copy_tree(self.slab, state.slab)

    def reset_counters(self) -> None:
        for t in (self.n_done, self.halted, self.sorts, self.rebuilds):
            t.zero_()

    def bundle(self, k: int) -> torch.Tensor:
        """The window's counters and first k diagnostics rows as one float64
        vector: n_done, halted, sorts, rebuilds, then the table."""
        head = torch.stack([t.to(torch.float64) for t in (self.n_done, self.halted, self.sorts, self.rebuilds)])
        return torch.cat([head, self.diag[:, :k].reshape(-1)])


def _window_step(buf: _WindowBuffers, config: PICConfig, policy: SortPolicyConfig, *, with_energies: bool,
                 decider) -> None:
    """One step of a window, in place on ``buf``; nothing once the window
    has halted. The step, then its sort mode's decision, then the step's
    diagnostics at row ``buf.n_done``:

    - ``incremental``: the re-sort policy, and the global sort under its
      word or on an overflow; a sort that still overflows halts the window;
    - ``global``: the global sort, every step (not a policy sort); its
      overflow halts the window;
    - ``rebuild``: the step rebuilt the bins; their overflow halts the window;
    - ``none``: nothing.

    Only ``incremental`` touches the policy state. The decisions go to
    ``decider.run_if`` (see `kernels.conditional`: tested on the host, or IF
    nodes of a captured graph)."""
    n_slots = config.grid.n_cells * config.capacity

    def policy_sort(stats: GPMAStats) -> None:
        with record_function("pic.policy"):
            if config.needs_bins:
                mandatory = stats.n_overflow > 0
            else:
                mandatory = torch.zeros((), dtype=torch.bool, device=buf.device)
            do_pol, _reason, recorded = policy_update(
                buf.pstate, policy, n_moved=stats.n_moved, n_alive=stats.n_alive,
                n_empty=stats.n_empty, n_slots=n_slots,
            )
            do_pol = do_pol & ~mandatory
        _copy_tree(buf.pstate, recorded)

        def sort():
            with record_function("pic.global_sort"):
                state, overflow = global_sort_device(buf.state(), config)
                buf.store(state)
                _copy_tree(buf.pstate, policy_reset(buf.device))
                buf.halted.logical_or_(overflow > 0)

        decider.run_if(do_pol | mandatory, sort)
        buf.sorts.add_(do_pol.to(torch.int64))
        buf.rebuilds.add_(mandatory.to(torch.int64))

    def step():
        new, stats = _pic_step(buf.state(), config)
        buf.store(new)
        if config.sort_mode == "incremental":
            policy_sort(stats)
        elif config.sort_mode == "global":
            with record_function("pic.global_sort"):
                state, overflow = global_sort_device(buf.state(), config)
                buf.store(state)
                buf.halted.logical_or_(overflow > 0)
        elif config.sort_mode == "rebuild":
            buf.halted.logical_or_(stats.n_overflow > 0)
        row = [stats.n_moved, stats.n_alive]
        if with_energies:
            row.extend(_energies(buf.state(), config))
        buf.diag.index_copy_(1, buf.n_done.reshape(1), torch.stack([r.to(torch.float64) for r in row])[:, None])
        buf.n_done.add_(1)

    decider.run_if(~buf.halted, step)


UNSET = object()


class Simulation:
    """Single-device driver: step, re-sort policy, global sort on the
    policy's word, capacity growth on a persistent overflow.

    Build it with `repro_torch.api.make_simulation(spec)`; the state's
    tensors decide the device. ``run(n, window=K)`` runs windows: on a CUDA
    device each window replays one captured CUDA graph of the step, with
    the sort decision and the window's halt as IF nodes (``use_graphs``,
    default on for CUDA); the state's tensors are then the graph's, updated
    in place. ``run(n, window=None)`` runs the host-driven loop, with its
    own policy counters (``host_policy``), as in the reference: pick one
    driver per simulation.
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
        self.device = particles.pos.device
        self.policy = policy or SortPolicyConfig()
        self.host_policy = ResortPolicy(self.policy)
        self.state = state
        self.policy_state = policy_init(self.device)
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
        #: the reference's fault-tolerance counters (retries, restarts,
        #: discarded_steps), which this driver does not keep: carried
        #: through a checkpoint unchanged
        self.carried_counters: dict[str, int] = {}

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

    # -- host reads ---------------------------------------------------------

    def _read(self, tensor: torch.Tensor):
        """Every device-to-host read of a run goes through here."""
        self.host_reads += 1
        return tensor.cpu()

    def run(self, n_steps: int | None = None, *, diagnostics_every: int | None = None, window=UNSET) -> None:
        """Advance `n_steps` (default: the spec's) in windows of `window`
        steps (default: the spec's; a spec's ``run.window == 0`` and a
        spec-less driver mean None), or with ``window=None`` in the
        host-driven loop."""
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
            self._run_host(n_steps, diagnostics_every)
            return
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        target = self._host_step + n_steps
        while self._host_step < target:
            k = min(window, target - self._host_step)
            host = self._run_window(k, with_energies=bool(diagnostics_every), n_diag=window)
            n_done = self._consume(host, diagnostics_every)
            code = int(host["halt_code"])
            if code == HALT_BIN_OVERFLOW:
                self.halts[HALT_NAMES[code]] = self.halts.get(HALT_NAMES[code], 0) + 1
                self._grow_capacity()
            elif n_done < k:
                raise RuntimeError("windowed driver made no progress without a halt")

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

    def _window_for(self, with_energies: bool, n_diag: int) -> dict:
        """The window's buffers and, on CUDA with ``use_graphs``, its
        captured step; made anew when the configuration, the diagnostics or
        the state's shapes change."""
        names = ("n_moved", "n_alive") + (("field_energy", "kinetic_energy") if with_energies else ())
        key = (self.config, self.policy, names, n_diag, self.use_graphs)
        if self._window is not None and self._window["key"] == key:
            return self._window
        buf = _WindowBuffers(self._state, self._policy_state, names, n_diag)
        w = {"key": key, "buffers": buf, "graph": None, "launches": {}}
        if self.use_graphs:
            self._capture(w, with_energies)
        self._window = w
        self._state, self._policy_state = buf.state(self._state.step), buf.pstate
        return w

    def _capture(self, w: dict, with_energies: bool) -> None:
        """Capture one guarded step of ``w``'s buffers as a CUDA graph, after
        one warm-up step on a copy of them that takes both branches (it
        brings every lazily built library object, such as a BLAS handle,
        into being before the capture). The kernel wrappers count launches
        when they run, which during a capture means once per recorded
        launch: those counts are taken back and added per replay."""
        buf = w["buffers"]
        step = lambda b, decider: _window_step(b, self.config, self.policy, with_energies=with_energies,
                                               decider=decider)
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        scratch = _WindowBuffers(buf.state(), buf.pstate, buf.names, buf.diag.shape[1])
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            step(scratch, EveryBranch())
        torch.cuda.current_stream(self.device).wait_stream(side)
        del scratch
        graph = torch.cuda.CUDAGraph()
        capture = GraphCapture(graph, self.device)
        before = kernels.launch_counts()
        with capture.capturing():
            step(buf, capture)
        after = kernels.launch_counts()
        w["launches"] = {name: after[name] - before[name] for name in after}
        kernels.add_launches(w["launches"], -1)
        w["graph"] = graph
        torch.cuda.synchronize(self.device)
        self.graph_captures += 1
        self.graph_setup_seconds += time.perf_counter() - t0

    def _run_window(self, k: int, *, with_energies: bool, n_diag: int) -> dict:
        """Up to k <= n_diag steps; stops after a step whose global sort
        still overflows. Returns the window's host bundle (one read)."""
        w = self._window_for(with_energies, n_diag)
        buf = w["buffers"]
        buf.reset_counters()
        if w["graph"] is not None:
            for _ in range(k):
                w["graph"].replay()
        else:
            decider = HostDecider(self._read)
            for _ in range(k):
                _window_step(buf, self.config, self.policy, with_energies=with_energies, decider=decider)
        self.windows += 1
        # the window's one bundle read
        host = self._read(buf.bundle(k)).numpy()
        n_done = int(host[0])
        if w["graph"] is not None:
            kernels.add_launches(w["launches"], n_done)
        self._state = buf.state(self._state.step + n_done)
        table = host[4:].reshape(len(buf.names), k)
        return {
            "n_done": n_done,
            "n_sorts": int(host[2]),
            "n_rebuilds": int(host[3]),
            "halt_code": HALT_BIN_OVERFLOW if host[1] else HALT_NONE,
            "per_step": dict(zip(buf.names, table)),
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

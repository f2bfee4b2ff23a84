"""The distributed driver on one device: a 2-D shard mesh held on the
shard stack of `repro_torch.pic.distributed`, run in windows. Counterpart
of `repro.pic.dist_simulation`.

The reference runs a K-step window as one compiled program, its scan
inside `shard_map`. Here a window step (`_dist_window_step`) runs every
shard's step, the exchanges between them and the step's decisions in place
on the window's buffers (`_DistWindowBuffers`, the state with its two
shard axes); on a CUDA device it is captured once as one CUDA graph whose
decisions are IF nodes (`kernels.conditional`), and a window is k replays
and one read of a ``[head + table]`` bundle. Each shard's kernels launch at
the local grid shape, one launch a shard a step. One window step:

  1. `dist_pic_step`          halo exchange, gather, push, bounded
                              migration, each shard's GPMA update,
                              deposition and guard fold, Maxwell
  2. the re-sort policy       over the mesh totals of the step's counters,
                              one decision for every shard
  3. the global sort          of every shard (IF node), on the word of the
                              policy or on an overflow
  4. the health sentinel      (optional) on the mesh totals, the imbalance
                              trigger, and the step's halt code
  5. the commit               (IF node) of the step, unless a receive-side
                              drop discards it

The host ends a window early only for these halts (the reference's):

  HALT_BIN_OVERFLOW    a bin stays overfull after the sort: the step is
                       kept, the host grows ``capacity`` (padding the slot
                       table) and the next window sorts first;
  HALT_MIG_SEND        a migrating particle found no buffer slot: the step
                       is kept (the straggler stays resident, masked), the
                       host doubles ``mig_cap``;
  HALT_MIG_RECV        an arrival found no dead slot and would have been
                       destroyed: the step is discarded, the host doubles
                       the shards' particle arrays (``n_local``) and the
                       next window replays the step's migration half from
                       the carried mid-step snapshot;
  HALT_IMBALANCE       (``comm.rebalance_enable``) the densest shard holds
                       more than ``imbalance_ratio`` times the mean: the
                       host re-splits the mesh (`plan_balanced_split`) on
                       the same device;
  HALT_NONFINITE, HALT_INVARIANT   the sentinel's, rolled back by the
                       supervisor (`distributed.fault`).

A growth changes the buffers' shapes and so captures the step anew.
`DistSimulation.run(n, window=None)` is the host-driven loop: one eager
step at a time, its counters read on the host, the host policy deciding.

Over a process group (a `PicMesh` of `make_pic_mesh` with a group, one
process a rank) each rank holds its block of the stack and runs the same
window on it: the halos and the migration cross ranks in the step's ring
shifts, and every counter, energy and sentinel measure the bundle holds is
a reduction over the whole mesh, so every rank reads the same bundle and
takes the same branch (grow, replay, re-split or halt). The growths and the
re-split see the global state by ``all_gather`` and re-partition it the
same way on every rank; a checkpoint is written by rank 0 from the global
view, in the one-process format.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import kernels
from repro_torch.core.binning import cell_index, choose_capacity
from repro_torch.core.health import (
    HALT_BIN_OVERFLOW,
    HALT_IMBALANCE,
    HALT_MIG_RECV,
    HALT_MIG_SEND,
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
from repro_torch.distributed.fault import (
    FAULT_NONE,
    PICFaultInjector,
    inject_fields,
    inject_momenta,
    inject_weights,
    injected_recv_drop,
    run_supervised_windows,
)
from repro_torch.distributed.ranks import choose_rank_grid
from repro_torch.distributed.sharding import plan_balanced_split
from repro_torch.kernels import dispatch
from repro_torch.pic.distributed import (
    STAT_KEYS,
    DistConfig,
    DistState,
    PicMesh,
    as_pic_mesh,
    blocks_from_global,
    build_local_bins,
    dist_global_sort_device,
    dist_pic_step,
    gather_shards,
    global_from_blocks,
    in_domain,
    n_mesh_shards,
    partition_particles,
    validate_shard_guard,
)
from repro_torch.pic.grid import FieldState, GridSpec
from repro_torch.pic.plasma import ParticleState
from repro_torch.pic.pusher import lorentz_gamma
from repro_torch.pic.simulation import (
    DEPRECATION_MSG,
    UNSET,
    Window,
    WindowStore,
    _WindowHead,
    _clone_tree,
    _copy_tree,
    _same_shapes,
    _shapes,
    consume_window_bundle,
    enter_entry,
    resolve_run_args,
)

__all__ = ["DIAG_NAMES", "DistSimulation", "DistWindowFn", "make_dist_window"]

#: the rows of a window's per-step table, the reference's ``per_step`` keys
DIAG_NAMES = ("active", "sorted", "reason", "n_moved", "n_alive", "mig_send_overflow", "mig_recv_dropped",
              "n_unmigrated", "n_migrated", "mig_payload_bytes", "max_shard_alive", "discarded", "field_energy",
              "kinetic_energy")


def _energies(state: DistState, cfg: DistConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(field, kinetic) energy, float32 device scalars: each shard's sums,
    then their sum over the mesh (the reference's per-shard sums and
    psum; over ranks the per-shard sums gathered first)."""
    f = state.fields.to(torch.float32)
    per_comp = 0.5 * torch.sum(f * f, dim=(-3, -2, -1))  # [6, SX, SY]
    field_e = sum(per_comp[k] for k in range(6)) * cfg.local_grid.cell_volume
    gamma = lorentz_gamma(state.u).to(torch.float32)
    kinetic = torch.sum(state.w.to(torch.float32) * state.alive.to(torch.float32) * cfg.mass * (gamma - 1.0), dim=-1)
    return gather_shards(field_e, cfg.ranks).sum(), gather_shards(kinetic, cfg.ranks).sum()


def _total_charge(state: DistState, cfg: DistConfig) -> torch.Tensor:
    per_shard = torch.sum(state.w.to(torch.float32) * state.alive.to(torch.float32), dim=-1)
    return gather_shards(per_shard, cfg.ranks).sum()


def _mesh_count(x: torch.Tensor, ranks) -> torch.Tensor:
    """A rank's 0-d count summed over the ranks, in its dtype."""
    return x if ranks is None else ranks.values(x).sum(dtype=x.dtype)


class _DistWindowBuffers(_WindowHead):
    """A window's state held in place, with the two shard axes: the tensors
    a step reads and then overwrites (``st``), the policy state, the
    window's counters, the halt latch and the per-step table. On the card
    they are the captured graph's inputs and outputs.

    ``entry`` is what the host (or, for `make_dist_window`'s window, the
    device) writes at a window's entry, in one copy: the absolute step it
    starts at, the fault vector (kind, step, component), the replay flag
    (``resume``: the first step replays the carried mid-step snapshot), the
    imbalance trigger's arming flag, the step target (a step runs only
    while ``n_done < target``) and the presort flag (`make_dist_window`'s
    entry sorts every shard under it; `DistSimulation` sorts before the
    window and writes 0). The counters add the count of discarded steps to
    the single-device driver's."""

    HEAD = _WindowHead.HEAD + ("discarded",)

    def __init__(self, state: DistState, pstate: SortPolicyState, n_diag: int):
        dev = state.pos.device
        self.device = dev
        self.st = _clone_tree(state)
        self.pstate = _clone_tree(pstate)
        self.names = DIAG_NAMES
        self.diag = torch.zeros((len(DIAG_NAMES), n_diag), dtype=torch.float64, device=dev)
        zeros = lambda dtype: torch.zeros((), dtype=dtype, device=dev)
        self.n_done, self.sorts, self.rebuilds, self.discarded = (zeros(torch.int64) for _ in range(4))
        self.halted = zeros(torch.bool)
        self.halt_code, self.halt_inv = zeros(torch.int32), zeros(torch.int32)
        self.halt_meas, self.halt_ref = zeros(torch.float32), zeros(torch.float32)
        self.entry = torch.tensor([0, FAULT_NONE, -1, 0, 0, 1, 0, 0], dtype=torch.int64, device=dev)
        self.step0, self.fault, self.resume, self.armed = self.entry[0], self.entry[1:4], self.entry[4], self.entry[5]
        self.target, self.presort = self.entry[6], self.entry[7]
        self.ref_charge, self.ref_energy = zeros(torch.float32), zeros(torch.float32)

    def store(self, state: DistState) -> None:
        """Commit a step: everything but the mid-step snapshot."""
        for f in dataclasses.fields(DistState):
            if f.name not in ("mid_pos", "mid_u"):
                getattr(self.st, f.name).copy_(getattr(state, f.name))

    def enter(self, step0: int, fault_vec: torch.Tensor | None, *, resume: bool, armed: bool, target: int) -> None:
        """The entry vector (the presort flag 0), written without waiting on
        the device (on CUDA an asynchronous copy from pinned memory)."""
        fault = fault_vec.tolist() if fault_vec is not None else (FAULT_NONE, -1, 0)
        self._write_entry([step0, *fault, int(resume), int(armed), target, 0])


def _parse_bundle(host: np.ndarray, k: int, step0: int) -> dict:
    """A window's bundle, read on the host, as the reference's fetched
    bundle dict. A halting step is the window's last: a kept one is its
    ``n_done``-th, a discarded one the step after."""
    n_head = len(_DistWindowBuffers.HEAD)
    head = dict(zip(_DistWindowBuffers.HEAD, host[:n_head]))
    code = int(head["halt_code"])
    n_done, n_discarded = int(head["n_done"]), int(head["discarded"])
    return {
        "n_done": n_done,
        "n_sorts": int(head["sorts"]),
        "n_rebuilds": int(head["rebuilds"]),
        "halt_code": code,
        "halt_step": step0 + n_done + n_discarded if code else -1,
        "halt_inv": int(head["halt_inv"]),
        "halt_measured": float(head["halt_meas"]),
        "halt_reference": float(head["halt_ref"]),
        "n_discarded": n_discarded,
        "per_step": dict(zip(DIAG_NAMES, host[n_head:].reshape(len(DIAG_NAMES), k))),
    }


def _dist_window_step(buf: _DistWindowBuffers, config: DistConfig, policy: SortPolicyConfig, *, with_energies: bool,
                      health: HealthConfig | None, with_fault: bool, decider) -> None:
    """One step of a distributed window, in place on ``buf``; nothing once
    the window has halted or has made its ``target`` steps. With
    ``with_fault`` the armed fault first corrupts the step's input where
    it fires. The step's candidate state
    is sorted (IF node) on the policy's word or an overflow, read by the
    sentinel, and committed (IF node) unless a receive-side drop discards
    it; the halt code ranks health, then the receive-side drop, the bin
    overflow, the send-side overflow and last the imbalance. The table's
    row for the step is written at ``n_done`` (a discarded step's row holds
    only its drop count)."""
    sx, sy = buf.st.pos.shape[:2]
    n_shards = n_mesh_shards(sx * sy, config.ranks)
    n_slots = n_shards * config.local_grid.n_cells * config.capacity
    dev = buf.device

    def step():
        st = buf.st
        step_abs = buf.step0 + buf.n_done
        if with_fault:
            fields = torch.stack(inject_fields(tuple(st.fields.unbind(0)), step_abs, buf.fault))
            st = dataclasses.replace(st, fields=fields, u=inject_momenta(st.u, step_abs, buf.fault),
                                     w=inject_weights(st.w, step_abs, buf.fault))
        use_mid = (buf.resume != 0) & (buf.n_done == 0)
        cand, stats = dist_pic_step(st, config, use_mid=use_mid)
        recv = stats["mig_recv_dropped"]
        if with_fault:
            recv = recv + injected_recv_drop(step_abs, buf.fault)

        with record_function("pic.policy"):
            mandatory = stats["n_overflow"] > 0
            do_pol, reason_pol, recorded = policy_update(buf.pstate, policy, n_moved=stats["n_moved"],
                                                         n_alive=stats["n_alive"], n_empty=stats["n_empty"],
                                                         n_slots=n_slots)
            do_pol = do_pol & ~mandatory
            do_sort = mandatory | do_pol
            reason = torch.where(mandatory, REASON_OVERFLOW, reason_pol)
            overflow = torch.zeros((), dtype=torch.int64, device=dev)

        def sort():
            with record_function("pic.global_sort"):
                *parts, of = dist_global_sort_device(cand.pos, cand.u, cand.w, cand.alive, config)
                for name, src in zip(("pos", "u", "w", "alive", "slots", "pslot", "slab_d", "slab_valid"), parts):
                    getattr(cand, name).copy_(src)
                overflow.copy_(of)

        decider.run_if(do_sort, sort)
        reset = policy_reset(dev)
        pstate_new = SortPolicyState(*(torch.where(do_sort, getattr(reset, f.name), getattr(recorded, f.name))
                                       for f in dataclasses.fields(SortPolicyState)))

        zero_f = torch.zeros((), dtype=torch.float32, device=dev)
        field_e = kinetic = zero_f
        if with_energies or (health is not None and health.check_energy):
            field_e, kinetic = _energies(cand, config)
        h_code = torch.zeros((), dtype=torch.int32, device=dev)
        h_inv, h_meas, h_ref = torch.zeros_like(h_code), zero_f, zero_f
        if health is not None:
            with record_function("pic.sentinel"):
                ff = mf = torch.zeros((), dtype=torch.int32, device=dev)
                if health.check_nonfinite:
                    ff = _mesh_count(nonfinite_count(list(cand.fields.unbind(0))), config.ranks)
                    mf = _mesh_count(nonfinite_count([cand.u, cand.pos], mask=cand.alive), config.ranks)
                h_code, h_inv, h_meas, h_ref = classify_health(
                    health, fields_nonfinite=ff, momenta_nonfinite=mf, charge=_total_charge(cand, config),
                    charge_ref=buf.ref_charge, energy=field_e + kinetic, energy_ref=buf.ref_energy)
        halt_imb = torch.zeros((), dtype=torch.bool, device=dev)
        if config.comm.rebalance_enable and n_shards > 1:
            n_alive_f = stats["n_alive"].to(torch.float32)
            halt_imb = ((buf.armed != 0) & (stats["n_alive"] > 0)
                        & (stats["max_shard_alive"].to(torch.float32) * float(n_shards)
                           > float(np.float32(config.comm.imbalance_ratio)) * n_alive_f))

        recv_drop = recv > 0
        i32 = lambda v: torch.full((), v, dtype=torch.int32, device=dev)
        step_code = torch.where(
            h_code != HALT_NONE, h_code,
            torch.where(recv_drop, i32(HALT_MIG_RECV),
                        torch.where(overflow > 0, i32(HALT_BIN_OVERFLOW),
                                    torch.where(stats["mig_send_overflow"] > 0, i32(HALT_MIG_SEND),
                                                torch.where(halt_imb, i32(HALT_IMBALANCE), i32(HALT_NONE))))))
        keep = ~recv_drop
        kept = lambda v: torch.where(keep, v.to(torch.float64), 0.0)
        row = [keep, do_sort & keep, kept(reason), kept(stats["n_moved"]), kept(stats["n_alive"]),
               kept(stats["mig_send_overflow"]), recv, kept(stats["n_unmigrated"]), kept(stats["n_migrated"]),
               kept(stats["mig_payload_bytes"]), kept(stats["max_shard_alive"]), recv_drop, kept(field_e),
               kept(kinetic)]
        buf.diag.index_copy_(1, buf.n_done.reshape(1), torch.stack([r.to(torch.float64) for r in row])[:, None])
        with record_function("pic.commit"):
            buf.st.mid_pos.copy_(cand.mid_pos)
            buf.st.mid_u.copy_(cand.mid_u)

        def commit():
            with record_function("pic.commit"):
                buf.store(cand)
                _copy_tree(buf.pstate, pstate_new)
                buf.sorts.add_(do_pol.to(torch.int64))
                buf.rebuilds.add_(mandatory.to(torch.int64))
                buf.n_done.add_(1)

        decider.run_if(keep, commit)
        buf.discarded.add_(recv_drop.to(torch.int64))
        bad = step_code != HALT_NONE
        for dst, value in zip((buf.halt_code, buf.halt_inv, buf.halt_meas, buf.halt_ref),
                              (step_code, h_inv, h_meas, h_ref)):
            dst.copy_(torch.where(bad, value, dst))
        buf.halted.logical_or_(bad)

    decider.run_if(~buf.halted & (buf.n_done < buf.target), step)


def _sort_shards(st: DistState, config: DistConfig) -> None:
    """Every shard's global sort at ``config.capacity``, in place in ``st``
    (the overflow is left to the next step's mandatory sort)."""
    *parts, _overflow = dist_global_sort_device(st.pos, st.u, st.w, st.alive, config)
    for name, src in zip(("pos", "u", "w", "alive", "slots", "pslot", "slab_d", "slab_valid"), parts):
        getattr(st, name).copy_(src)


def _dist_window_entry(buf: _DistWindowBuffers, config: DistConfig, health: HealthConfig | None, *,
                       decider) -> None:
    """A functional window's entry: every shard's sort when the entry's
    presort flag is set (the capacity growth's re-entry), then the
    sentinel's references from the state the steps start at."""
    decider.run_if(buf.presort != 0, lambda: _sort_shards(buf.st, config))
    if health is not None:
        fe, ke = _energies(buf.st, config)
        buf.ref_charge.copy_(_total_charge(buf.st, config))
        buf.ref_energy.copy_(fe + ke)


def _prewarm_local(config: DistConfig, pos: torch.Tensor, alive: torch.Tensor) -> None:
    """Resolve ``config``'s ``auto`` dispatch keys eagerly at the local
    grid shape, the shape each shard's kernels run at, a timing at the
    mesh's mean occupancy (``pos`` and ``alive`` the shard stacks; a set-up
    read). Over ranks the choice is the mesh's: rank 0 resolves and every
    rank keeps rank 0's backends (`RankGrid.agree`), so the ranks of one
    mesh run the same kernels."""
    if config.backend != "auto":
        return
    local, ranks = config.local_grid, config.ranks
    n_alive = torch.count_nonzero(alive)
    if ranks is not None:
        n_alive = ranks.values(n_alive).sum()
    fill = -(-int(n_alive) // (n_mesh_shards(alive.shape[0] * alive.shape[1], ranks) * local.n_cells))
    ops = dispatch.ops_for_modes(config.deposition, config.gather)
    key = dict(device=alive.device, order=config.order, grid_shape=local.shape, capacity=config.capacity,
               dtype=pos.dtype)
    if ranks is None:
        dispatch.prewarm(ops, fill=fill, **key)
        return
    names = sorted(dispatch.BACKEND_PRIORITY)
    chosen = dispatch.prewarm(ops, fill=fill, **key) if ranks.rank == 0 else {}
    for op in ops:
        dispatch.remember(op, names[ranks.agree(names.index(chosen.get(op, names[0])))], **key)


def _pad(t: torch.Tensor, dim: int, add: int, fill) -> torch.Tensor:
    """``t`` with ``add`` entries of ``fill`` appended along ``dim``."""
    shape = list(t.shape)
    shape[dim] = add
    return torch.cat([t, torch.full(shape, fill, dtype=t.dtype, device=t.device)], dim=dim)


class DistSimulation:
    """The distributed driver: the single-device driver's surface on a 2-D
    shard mesh held on one device, or spread over the ranks of a process
    group (``mesh``, a `PicMesh` with a rank grid), each rank holding its
    block of the stack.

    It takes global fields and particles, as `Simulation` does, and splits
    them over an ``(sx, sy)`` mesh once, here (`partition_particles`); a
    rank keeps its block.
    ``run(n, window=K)`` runs windows of K steps under the fault supervisor
    (`distributed.fault.run_supervised_windows`); on a CUDA device each
    window replays one captured CUDA graph of the step (``use_graphs``) and
    makes one host read. ``run(n, window=None)`` runs the host-driven loop
    (one read of the step's counters a step and the host policy). Pick one
    driver per simulation: they keep their own policy counters.

    Build it with `repro_torch.api.make_simulation` on a spec with a mesh
    (built directly, with no spec, it warns `DeprecationWarning`, as the
    reference's). ``host_reads`` counts the device-to-host reads of a run:
    one a window, one more a capacity growth; about one a step in the
    host-driven loop. Over ranks every rank makes the same calls: each
    reduction, growth, re-split, view of the global frame and checkpoint
    is collective.
    """

    def __init__(self, fields: FieldState, particles: ParticleState, config: DistConfig, *, mesh=None,
                 mesh_shape=None, n_local: int | None = None, policy: SortPolicyConfig | None = None, spec=None):
        if spec is None:
            warnings.warn(DEPRECATION_MSG.format(cls="DistSimulation"), DeprecationWarning, stacklevel=2)
        if mesh is None:
            if mesh_shape is None:
                raise ValueError("pass either a mesh or mesh_shape=(sx, sy)")
            mesh = mesh_shape
        self.mesh = as_pic_mesh(mesh)
        self.spec = spec
        self.config = dataclasses.replace(config, ranks=self.ranks)
        self.sx, self.sy = self.mesh.shape
        local = config.local_grid
        self.global_grid = GridSpec(shape=(local.shape[0] * self.sx, local.shape[1] * self.sy, local.shape[2]),
                                    dx=local.dx)
        fshape = tuple(fields.ex.shape)
        if fshape != self.global_grid.shape:
            raise ValueError(f"field arrays have shape {fshape} but mesh {self.sx}x{self.sy} of local blocks "
                             f"{local.shape} implies a global grid {self.global_grid.shape}")
        self.device = particles.pos.device
        if self.ranks is not None and self.ranks.device != self.device:
            raise ValueError(f"the particles are on {self.device} but this rank's tensors live on "
                             f"{self.ranks.device}")
        self.n_local = n_local or self._default_n_local(particles)
        pos, u, w, alive = partition_particles(particles, self.global_grid, self.sx, self.sy, self.n_local,
                                               ranks=self.ranks)
        while True:  # grow up front if the initial density overflows
            slots, pslot, slab_d, slab_valid, overflow = build_local_bins(pos, alive, local, self.config.capacity,
                                                                          self.ranks)
            if not overflow:
                break
            self.config = dataclasses.replace(self.config, capacity=self.config.capacity * 2)
        self.policy = policy or SortPolicyConfig()
        self.host_policy = ResortPolicy(self.policy)
        self.shard_state = DistState(fields=blocks_from_global(fields.all(), self.sx, self.sy, self.ranks), pos=pos,
                                     u=u, w=w, alive=alive, slots=slots, pslot=pslot, slab_d=slab_d,
                                     slab_valid=slab_valid, mid_pos=torch.zeros_like(pos), mid_u=torch.zeros_like(u))
        self.policy_state = policy_init(self.device)
        self.use_graphs = self.device.type == "cuda"
        self.sorts = 0
        self.rebuilds = 0
        self._pending_presort = False  # the next window sorts first (after a capacity growth)
        self._pending_resume = False   # the next window replays a discarded step's migration
        self.growths = {"capacity": 0, "mig_cap": 0, "n_local": 0, "rebalance": 0}
        self.mig_recv_dropped = 0      # the host-driven loop's; a window never drops
        self.comm_stats = {"n_migrated": 0, "mig_payload_bytes": 0, "max_imbalance": 0.0}
        # the imbalance halt stays armed until a re-split finds no better
        # split (firing again would halt every window on the same state)
        self._rebalance_armed = True
        self.history: list[dict] = []
        self._host_step = 0
        self.windows = 0
        self.host_reads = 0
        self.graph_captures = 0
        self.graph_setup_seconds = 0.0
        self.halts: dict[str, int] = {}
        self.retries = 0
        self.restarts = 0
        self.discarded_steps = 0
        self._remedy_level = 0
        self._health = spec.health if (spec is not None and spec.health.enable) else None
        self.fault_injector = PICFaultInjector(spec.fault) if (spec is not None and spec.fault is not None) else None
        self._snapshot: dict | None = None
        self._prewarm_dispatch()

    def _default_n_local(self, particles: ParticleState) -> int:
        """1.5 times the densest shard's particles, a multiple of 8."""
        nx_loc, ny_loc = self.config.local_grid.shape[:2]
        pos = particles.pos.detach().cpu().numpy()
        alive = particles.alive.detach().cpu().numpy()
        ix = np.clip((pos[:, 0] // nx_loc).astype(int), 0, self.sx - 1)
        iy = np.clip((pos[:, 1] // ny_loc).astype(int), 0, self.sy - 1)
        counts = np.bincount((ix * self.sy + iy)[alive], minlength=self.sx * self.sy)
        peak = int(counts.max()) if counts.size else 0
        return max(8, -(-int(peak * 1.5) // 8) * 8)

    @property
    def ranks(self):
        """The rank grid (`repro_torch.distributed.ranks.RankGrid`), or None
        in one process."""
        return self.mesh.ranks

    @property
    def is_writer(self) -> bool:
        """Whether this process writes what the run writes (rank 0)."""
        return self.ranks is None or self.ranks.rank == 0

    # -- state: assigning it drops the window's buffers and graph -------------

    @property
    def shard_state(self) -> DistState:
        """The state on the shard stack, the driver's own tensors (the
        window's buffers once a window has run); over ranks, this rank's
        block of it."""
        return self._state

    @shard_state.setter
    def shard_state(self, value: DistState) -> None:
        self._state = value
        self._window = None

    @property
    def state(self) -> dict:
        """The reference's state dict: ``fields``, the six components on the
        global (NX, NY, NZ) grid (copies), and the shard-stacked ``pos``,
        ``u``, ``w``, ``alive``, ``slots``, ``pslot``, ``slab_d``,
        ``slab_valid``, ``mid_pos`` and ``mid_u`` (the driver's own). Over
        ranks, this rank's block: its shards' stacks and the part of the
        grid they cover (`global_state` is the whole mesh's)."""
        st = self._state
        out = {f.name: getattr(st, f.name) for f in dataclasses.fields(DistState) if f.name != "fields"}
        out["fields"] = tuple(global_from_blocks(st.fields).unbind(0))
        return out

    @state.setter
    def state(self, tree: dict) -> None:
        """Install a state dict of the reference's layout, of this mesh (over
        ranks, of this rank's block); a tree without the replay snapshot
        gets zeros (no replay is pending at a checkpoint)."""
        bx, by = self.mesh.block
        pos, u = tree["pos"], tree["u"]
        self.shard_state = DistState(
            fields=blocks_from_global(tree["fields"], bx, by), pos=pos, u=u, w=tree["w"],
            alive=tree["alive"], slots=tree["slots"], pslot=tree["pslot"], slab_d=tree["slab_d"],
            slab_valid=tree["slab_valid"], mid_pos=tree.get("mid_pos", torch.zeros_like(pos)),
            mid_u=tree.get("mid_u", torch.zeros_like(u)))

    def global_state(self) -> dict:
        """`state` of the whole mesh: over ranks every rank's block gathered
        (a collective; the same dict on every rank)."""
        if self.ranks is None:
            return self.state
        st = self._state
        out = {f.name: self.ranks.gather(getattr(st, f.name)) for f in dataclasses.fields(DistState)
               if f.name != "fields"}
        out["fields"] = tuple(global_from_blocks(st.fields, self.ranks).unbind(0))
        return out

    def set_global_state(self, tree: dict) -> None:
        """Install a state dict of the whole mesh: over ranks, every rank
        keeps its block."""
        if self.ranks is None:
            self.state = tree
            return
        local = {k: self.ranks.block(v).contiguous() for k, v in tree.items() if k != "fields"}
        local["fields"] = global_from_blocks(blocks_from_global(tree["fields"], self.sx, self.sy, self.ranks)).unbind(0)
        self.state = local

    @property
    def policy_state(self) -> SortPolicyState:
        return self._policy_state

    @policy_state.setter
    def policy_state(self, value: SortPolicyState) -> None:
        self._policy_state = value
        self._window = None

    @property
    def mesh_shape(self) -> tuple[int, int]:
        return self.sx, self.sy

    def _install(self, state: DistState, pstate: SortPolicyState) -> None:
        """Make (state, pstate), of the current shapes, the driver's: into
        the window's buffers when there is a window, else assigned."""
        if self._window is None:
            self.shard_state, self.policy_state = state, pstate
            return
        buf = self._window.buffers
        _copy_tree(buf.st, state)
        _copy_tree(buf.pstate, pstate)

    def _read(self, tensor: torch.Tensor):
        """Every device-to-host read of a run goes through here."""
        self.host_reads += 1
        return tensor.cpu()

    # -- drivers ----------------------------------------------------------------

    def run(self, n_steps: int | None = None, *, diagnostics_every: int | None = None, window=UNSET,
            autosave_every: int | None = None, autosave_path: str | None = None) -> None:
        """Advance ``n_steps`` (default: the spec's) in windows of ``window``
        steps (default: the spec's), or with ``window=None`` in the
        host-driven loop; ``autosave_every=N`` checkpoints the windowed run
        every N steps and restores the latest after an exception."""
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
        """Checkpoint in the reference's format (`repro_torch.checkpoint`)."""
        from repro_torch.checkpoint import save_simulation

        save_simulation(self, path)

    def restore(self, path: str) -> None:
        """Restore a checkpoint of a compatible run, written by either
        package."""
        from repro_torch.checkpoint import restore_simulation

        restore_simulation(self, path)

    # -- the windowed driver ----------------------------------------------------

    def _window_for(self, with_energies: bool, n_diag: int) -> Window:
        """The window's buffers and, on CUDA with ``use_graphs``, its
        captured step; made anew when the configuration, the table's length,
        the sentinel or the state's shapes change. A driver with a fault
        spec captures the injection into every window (an unarmed vector
        never fires)."""
        with_fault = self.fault_injector is not None
        key = (self.config, self.policy, with_energies, n_diag, self.use_graphs, self._health, with_fault)
        if self._window is not None and self._window.key == key:
            return self._window
        buf = _DistWindowBuffers(self._state, self._policy_state, n_diag)
        w = Window(key, buf, functools.partial(_dist_window_step, config=self.config, policy=self.policy,
                                               with_energies=with_energies, health=self._health,
                                               with_fault=with_fault))
        if self.use_graphs:
            self.graph_setup_seconds += w.capture()
            self.graph_captures += 1
            # the capture's warm-up step ran on the buffers: the state back in
            _copy_tree(buf.st, self._state)
            _copy_tree(buf.pstate, self._policy_state)
        self._window = w
        self._state, self._policy_state = buf.st, buf.pstate
        return w

    def _enter_window(self, k: int, window: int, diagnostics_every: int, fault_vec) -> dict:
        """Run one window of up to k steps (its table sized for ``window``)
        and read its bundle: the window's one device-to-host read. Consumes
        the pending presort and replay flags."""
        w = self._window_for(bool(diagnostics_every), window)
        buf = w.buffers
        if self._pending_presort:  # the capacity growth's re-sort, before the first step
            _sort_shards(buf.st, self.config)
        buf.reset_counters()
        buf.enter(self._host_step, fault_vec, resume=self._pending_resume, armed=self._rebalance_armed, target=k)
        self._pending_presort = self._pending_resume = False
        if self._health is not None:
            # the sentinel's references, from the state the window starts at
            fe, ke = _energies(buf.st, self.config)
            buf.ref_charge.copy_(_total_charge(buf.st, self.config))
            buf.ref_energy.copy_(fe + ke)
        w.run(k, self._read)
        self.windows += 1
        host = _parse_bundle(self._read(buf.bundle(k)).numpy(), k, self._host_step)
        if w.graph is not None:
            kernels.add_launches(w.launches, host["n_done"] + host["n_discarded"])
        return host

    def _consume_bundle(self, host: dict, diagnostics_every: int) -> int:
        """Commit a window that did not halt on health: its diagnostics,
        counters and communication totals."""
        n_done, n_sorts, n_rebuilds = consume_window_bundle(host, self._host_step, diagnostics_every, self.history)
        self.sorts += n_sorts
        self.rebuilds += n_rebuilds
        self._host_step += n_done
        per = host["per_step"]
        self.comm_stats["n_migrated"] += int(np.sum(per["n_migrated"]))
        self.comm_stats["mig_payload_bytes"] += int(np.sum(per["mig_payload_bytes"]))
        n_alive, peak = np.asarray(per["n_alive"]), np.asarray(per["max_shard_alive"])
        mask = n_alive > 0
        if mask.any():
            ratio = float(np.max(peak[mask] * (self.sx * self.sy) / n_alive[mask]))
            self.comm_stats["max_imbalance"] = max(self.comm_stats["max_imbalance"], ratio)
        return n_done

    # -- the supervisor's hooks ---------------------------------------------------

    def _take_snapshot(self) -> dict:
        """The window's entry state, policy state and re-entry flags, copied
        on the device into buffers of the driver's own (made once for each
        set of shapes)."""
        trees = [self._state, self._policy_state]
        snap = self._snapshot
        if snap is None or not _same_shapes(snap["trees"], trees):
            snap = self._snapshot = {"trees": [_clone_tree(t) for t in trees]}
        else:
            for dst, src in zip(snap["trees"], trees):
                _copy_tree(dst, src)
        snap["flags"] = (self._pending_presort, self._pending_resume)
        return snap

    def _restore_snapshot(self, snap: dict) -> None:
        """Roll back to a snapshot, in place in the window's buffers."""
        self._install(*snap["trees"])
        self._pending_presort, self._pending_resume = snap["flags"]

    def _handle_halt(self, code: int, host: dict) -> None:
        if code == HALT_BIN_OVERFLOW:
            self._grow_capacity()
        elif code == HALT_MIG_SEND:
            self._grow_mig_cap()
        elif code == HALT_MIG_RECV:
            self._grow_n_local()
            self._pending_resume = True  # replay the discarded step's migration
        elif code == HALT_IMBALANCE:
            self._rebalance()
        else:
            raise RuntimeError(f"distributed driver cannot handle halt code {code} ({HALT_NAMES[code]})")

    def _remedy_sort(self) -> None:
        """The ladder's second rung: every shard's global sort and a reset
        of the device policy state."""
        self._dist_sort()
        self._install(self._state, policy_init(self.device))

    def _demote_backend(self) -> bool:
        """The ladder's last rungs: the backend one step down the
        dispatcher's ladder (``cuda_reduced`` -> ``cuda`` -> ``torch``), as
        the single-device driver's (the shards run the kernels). False at
        the bottom."""
        nxt = dispatch.demote(self.config.backend, device=self.device, order=self.config.order,
                              grid_shape=self.config.local_grid.shape, capacity=self.config.capacity,
                              dtype=self._state.pos.dtype)
        if nxt is None:
            return False
        self.config = dataclasses.replace(self.config, backend=nxt)
        return True

    def _prewarm_dispatch(self) -> None:
        """Resolve the config's ``auto`` dispatch keys eagerly at the local
        grid shape, the shape each shard's kernels run at, so that the
        captured step finds them in the memo; again after a growth, a
        re-split and a restore. A timing runs at the mesh's mean
        occupancy (a set-up read, outside `host_reads`)."""
        _prewarm_local(self.config, self._state.pos, self._state.alive)

    # -- the host-driven loop -------------------------------------------------------

    def _run_host(self, n_steps: int, diagnostics_every: int) -> None:
        """One eager step at a time, the step's counters read on the host in
        one read, the growths and the host policy as the reference's
        `_run_host`: a receive-side drop here is a real loss, counted in
        ``mig_recv_dropped``, and grows ``n_local`` so it stops."""
        for _ in range(n_steps):
            n_slots = self.sx * self.sy * self.config.local_grid.n_cells * self.config.capacity
            t0 = time.perf_counter()
            old = self._state
            new, stats = dist_pic_step(old, self.config)
            self.shard_state = dataclasses.replace(new, mid_pos=old.mid_pos, mid_u=old.mid_u)
            host = self._read(torch.stack([stats[k].to(torch.int64) for k in STAT_KEYS]))
            stats = dict(zip(STAT_KEYS, (int(v) for v in host)))
            self._host_step += 1
            self.comm_stats["n_migrated"] += stats["n_migrated"]
            self.comm_stats["mig_payload_bytes"] += stats["mig_payload_bytes"]
            if stats["n_alive"]:
                self.comm_stats["max_imbalance"] = max(self.comm_stats["max_imbalance"],
                                                       stats["max_shard_alive"] * self.sx * self.sy / stats["n_alive"])
            if stats["mig_recv_dropped"]:
                self.mig_recv_dropped += stats["mig_recv_dropped"]
                self._grow_n_local()
            if stats["mig_send_overflow"]:
                self._grow_mig_cap()
            if stats["n_overflow"] > 0:
                self._dist_sort()
                self.rebuilds += 1
                self.host_policy.reset()
            else:
                dt = time.perf_counter() - t0
                self.host_policy.record_step(rebuilt=False, perf=float(stats["n_alive"]) / max(dt, 1e-9))
                do, _reason = self.host_policy.should_sort(empty_ratio=stats["n_empty"] / max(n_slots, 1))
                if self.ranks is not None:  # the wall clock differs between ranks: rank 0 decides
                    do = bool(self.ranks.agree(do))
                if do:
                    self._dist_sort()
                    self.sorts += 1
                    self.host_policy.reset()
            if diagnostics_every and self._host_step % diagnostics_every == 0:
                self.history.append(self._diagnostics(self._read))

    # -- growths ---------------------------------------------------------------------

    def _dist_sort(self) -> None:
        """Every shard's global sort at the current capacity, its overflow
        read on the host; the capacity doubles until the bins hold every
        resident particle."""
        while True:
            st = self._state
            *parts, overflow = dist_global_sort_device(st.pos, st.u, st.w, st.alive, self.config)
            sorted_st = dataclasses.replace(st, **dict(zip(
                ("pos", "u", "w", "alive", "slots", "pslot", "slab_d", "slab_valid"), parts)))
            if int(self._read(overflow)) == 0:
                self._install(sorted_st, self._policy_state)
                return
            self.config = dataclasses.replace(self.config, capacity=self.config.capacity * 2)
            self.growths["capacity"] += 1
            assert self.config.capacity <= 2 * max(self.n_local, 1), "binning overflow persists with capacity > n_local"
            self.shard_state = sorted_st
            self._prewarm_dispatch()

    def _needed_capacity(self) -> int:
        """Occupancy of the densest (shard, cell) of the current state, in
        one read; stragglers occupy no bin."""
        local = self.config.local_grid
        st = self._state
        bx, by = st.pos.shape[:2]
        ok = st.alive & in_domain(st.pos, local.shape)
        cells = cell_index(st.pos, local.shape)
        shard = torch.arange(bx * by, device=self.device).reshape(bx, by, 1)
        counts = torch.zeros(bx * by * local.n_cells, dtype=torch.int64, device=self.device)
        counts.index_add_(0, (shard * local.n_cells + cells).reshape(-1), ok.reshape(-1).to(torch.int64))
        peak = counts.max() if self.ranks is None else self.ranks.values(counts.max()).amax()
        return int(self._read(peak))

    def _grow_capacity(self) -> None:
        """After ``HALT_BIN_OVERFLOW``: grow the capacity once to fit the
        densest cell (with headroom, at least doubling) by padding the slot
        table and the slab, and have the next window sort first (which slots
        the overflowed particles at the new capacity)."""
        old_cap = self.config.capacity
        new_cap = max(choose_capacity(self._needed_capacity()), old_cap * 2)
        self.config = dataclasses.replace(self.config, capacity=new_cap)
        self.growths["capacity"] += 1
        assert new_cap <= 2 * max(self.n_local, 8), "binning overflow persists with capacity > n_local"
        add = new_cap - old_cap
        st = self._state
        ps = st.pslot
        # flat slot ids are cell * capacity + rank: the new row stride
        pslot = torch.where(ps >= 0, (ps // old_cap) * new_cap + ps % old_cap, ps)
        self.shard_state = dataclasses.replace(st, slots=_pad(st.slots, 3, add, -1), slab_d=_pad(st.slab_d, 3, add, 0.0),
                                         slab_valid=_pad(st.slab_valid, 3, add, False), pslot=pslot)
        self._pending_presort = True
        self._prewarm_dispatch()

    def _grow_mig_cap(self) -> None:
        self.config = dataclasses.replace(self.config, mig_cap=self.config.mig_cap * 2)
        self.growths["mig_cap"] += 1
        assert self.config.mig_cap <= 4 * max(self.n_local, 1), "migration buffer growth runaway: mig_cap > 4 n_local"

    def _grow_n_local(self) -> None:
        """Double the shards' particle arrays with dead padding (slot ids
        name particle indices, which padding keeps)."""
        add = self.n_local
        st = self._state
        self.shard_state = dataclasses.replace(
            st, pos=_pad(st.pos, 2, add, 0.0), u=_pad(st.u, 2, add, 0.0), w=_pad(st.w, 2, add, 0.0),
            alive=_pad(st.alive, 2, add, False), pslot=_pad(st.pslot, 2, add, -1),
            mid_pos=_pad(st.mid_pos, 2, add, 0.0), mid_u=_pad(st.mid_u, 2, add, 0.0))
        self.n_local += add
        self.growths["n_local"] += 1

    def _rebalance(self) -> None:
        """After ``HALT_IMBALANCE`` (the halting step was kept): re-split the
        mesh to the split with the fewest particles on its densest shard
        (`plan_balanced_split`) and re-partition on the same device, as
        construction does, sizing ``n_local`` to the new peak. With no
        strictly better split the trigger disarms instead, until a later
        successful re-split."""
        parts = self.particles_global()
        fields = self.fields_global()
        pos = parts.pos.cpu().numpy()
        alive = parts.alive.cpu().numpy()
        nx_loc, ny_loc = self.config.local_grid.shape[:2]
        ix = np.clip((pos[alive, 0] // nx_loc).astype(int), 0, self.sx - 1)
        iy = np.clip((pos[alive, 1] // ny_loc).astype(int), 0, self.sy - 1)
        cur_peak = int(np.bincount(ix * self.sy + iy, minlength=self.sx * self.sy).max()) if alive.any() else 0
        world = 1 if self.ranks is None else self.ranks.world
        # over ranks only the splits that admit a rank grid of the group
        admits = lambda sx, sy: choose_rank_grid(world, sx, sy) is not None
        sx, sy, peak = plan_balanced_split(self.sx * self.sy, self.global_grid.shape, self.config.order, pos, alive,
                                           admits=admits)
        if (sx, sy) == (self.sx, self.sy) or peak >= cur_peak:
            self._rebalance_armed = False
            return
        gshape = self.global_grid.shape
        local = GridSpec(shape=(gshape[0] // sx, gshape[1] // sy, gshape[2]), dx=self.config.local_grid.dx)
        ranks = None if self.ranks is None else self.ranks.regrid(*choose_rank_grid(world, sx, sy))
        self.mesh = PicMesh(sx, sy, ranks)
        self.sx, self.sy = sx, sy
        self.config = dataclasses.replace(self.config, local_grid=local, ranks=ranks)
        self.n_local = max(8, -(-int(peak * 1.5) // 8) * 8)
        pos, u, w, alive = partition_particles(parts, self.global_grid, sx, sy, self.n_local, ranks=ranks)
        while True:
            slots, pslot, slab_d, slab_valid, overflow = build_local_bins(pos, alive, local, self.config.capacity,
                                                                          ranks)
            if not overflow:
                break
            self.config = dataclasses.replace(self.config, capacity=self.config.capacity * 2)
            self.growths["capacity"] += 1
        # a re-split follows a kept step: no replay is pending
        self.shard_state = DistState(fields=blocks_from_global(fields.all(), sx, sy, ranks), pos=pos, u=u, w=w,
                                     alive=alive, slots=slots, pslot=pslot, slab_d=slab_d, slab_valid=slab_valid,
                                     mid_pos=torch.zeros_like(pos), mid_u=torch.zeros_like(u))
        self._pending_presort = self._pending_resume = False
        self._rebalance_armed = True
        self.growths["rebalance"] += 1
        # checkpoints written after the re-split rebuild the new mesh
        if self.spec is not None:
            self.spec = dataclasses.replace(self.spec, mesh=dataclasses.replace(self.spec.mesh, shape=(sx, sy)))
        self._snapshot = None
        self._prewarm_dispatch()

    # -- views on the global frame ------------------------------------------------------

    def fields_global(self) -> FieldState:
        """The fields on the global (NX, NY, NZ) grid (copies; over ranks
        gathered, a collective)."""
        return FieldState(*global_from_blocks(self._state.fields, self.ranks).unbind(0))

    def particles_global(self) -> ParticleState:
        """Every particle slot, flattened, positions in the global frame
        (dead padding stays dead; a straggler keeps its out-of-range local
        position, shifted by its current shard's origin). Over ranks every
        block is gathered (a collective), in the one process's order."""
        st = self._state
        full = lambda t: gather_shards(t, self.ranks)
        nx_loc, ny_loc = self.config.local_grid.shape[:2]
        pos = full(st.pos).clone()
        for a in range(self.sx):
            pos[a, :, :, 0] += a * nx_loc
        for b in range(self.sy):
            pos[:, b, :, 1] += b * ny_loc
        return ParticleState(pos=pos.reshape(-1, 3), u=full(st.u).reshape(-1, 3), w=full(st.w).reshape(-1),
                             alive=full(st.alive).reshape(-1))

    def diagnostics(self) -> dict:
        return self._diagnostics(torch.Tensor.cpu)

    def _diagnostics(self, read) -> dict:
        """Step, energies and live particles of the current state, in one
        read through ``read``."""
        fe, ke = _energies(self._state, self.config)
        n_alive = gather_shards(torch.sum(self._state.alive, dim=-1), self.ranks).sum()
        host = read(torch.stack([fe.to(torch.float64), ke.to(torch.float64), n_alive.to(torch.float64)]))
        em, kinetic = float(host[0]), float(host[1])
        return {"step": self._host_step, "field_energy": em, "kinetic_energy": kinetic,
                "total_energy": em + kinetic, "n_alive": int(host[2])}


# -- the reference's functional window builder ----------------------------------------------


def _dist_window_bundle(buf: _DistWindowBuffers, n_steps: int) -> dict:
    """A functional distributed window's bundle, every leaf a fresh device
    tensor: the reference's keys, its ``per_step`` rows `DIAG_NAMES` of
    shape (n_steps,), zero past the steps run. A halting step is the
    window's last: a kept one its ``n_done``-th, a discarded one the step
    after."""
    i32 = torch.int32
    n_done, n_discarded = buf.n_done.to(i32), buf.discarded.to(i32)
    ran = torch.arange(n_steps, device=buf.device) < n_done + n_discarded
    per_step = {}
    for k, name in enumerate(DIAG_NAMES):
        dtype = torch.bool if name in ("active", "sorted") else torch.float32 if name.endswith("_energy") else i32
        per_step[name] = torch.where(ran, buf.diag[k], 0.0).to(dtype)
    code = buf.halt_code.clone()
    last = (buf.step0 + buf.n_done + buf.discarded).to(i32)
    return {
        "n_done": n_done,
        "n_sorts": buf.sorts.to(i32),
        "n_rebuilds": buf.rebuilds.to(i32),
        "halt_code": code,
        "halt_step": torch.where(code != HALT_NONE, last, torch.full_like(last, -1)),
        "halt_inv": buf.halt_inv.clone(),
        "halt_measured": buf.halt_meas.clone(),
        "halt_reference": buf.halt_ref.clone(),
        "n_discarded": n_discarded,
        "per_step": per_step,
    }


class DistWindowFn(WindowStore):
    """The window `make_dist_window` builds: a callable with the reference's
    18 arguments and 13 outputs, and a store of captured windows of its own
    (`WindowStore`), keyed by the shapes of the state and its device. On a
    CUDA device a window is two captured graphs: the entry (every shard's
    sort under the presort flag, the sentinel's references) and the guarded
    step (`_dist_window_step`), replayed ``n_steps`` times. The inputs are
    donated, as the reference's are: the caller's tensors are copied into
    the window's own buffers, and the result back into them, which come
    back; ``n_target``, ``presort``, ``resume``,
    ``step0``, ``rebalance_armed`` and ``fault_vec`` may be host values or
    device tensors, and a call on a window already built reads nothing back
    and captures nothing. Over ranks (a `PicMesh` with a rank grid) the
    arguments are this rank's block: its shards' stacks and the part of the
    grid they cover, and every rank calls the window together."""

    def __init__(self, mesh: PicMesh, config: DistConfig, policy: SortPolicyConfig, n_steps: int, *,
                 with_energies: bool, health: HealthConfig | None, with_fault: bool):
        super().__init__()
        self.sx, self.sy = mesh.block
        self.config = dataclasses.replace(config, ranks=mesh.ranks)
        self.policy, self.n_steps = policy, int(n_steps)
        self.with_energies, self.health, self.with_fault = with_energies, health, with_fault

    def __call__(self, fields, pos, u, w, alive, slots, pslot, slab_d, slab_valid, mid_pos, mid_u, policy_state,
                 n_target, presort, resume, step0, rebalance_armed, fault_vec):
        if tuple(pos.shape[:2]) != (self.sx, self.sy):
            raise ValueError(f"pos has shard axes {tuple(pos.shape[:2])}, not the mesh's ({self.sx}, {self.sy})")
        state = DistState(fields=blocks_from_global(fields, self.sx, self.sy), pos=pos, u=u, w=w, alive=alive,
                          slots=slots, pslot=pslot, slab_d=slab_d, slab_valid=slab_valid, mid_pos=mid_pos,
                          mid_u=mid_u)
        key = (str(pos.device), _shapes([state, policy_state]))

        def build() -> Window:
            _prewarm_local(self.config, pos, alive)
            buf = _DistWindowBuffers(state, policy_state, self.n_steps)
            step = functools.partial(_dist_window_step, config=self.config, policy=self.policy,
                                     with_energies=self.with_energies, health=self.health,
                                     with_fault=self.with_fault)
            return Window(key, buf, step, functools.partial(_dist_window_entry, config=self.config,
                                                            health=self.health))

        win = self.window(key, build)
        buf = win.buffers
        _copy_tree(buf.st, state)
        _copy_tree(buf.pstate, policy_state)
        buf.reset_counters()
        enter_entry(buf, {0: step0, slice(1, 4): fault_vec, 4: resume, 5: rebalance_armed, 6: n_target,
                          7: presort})
        win.run(self.n_steps)
        bundle = _dist_window_bundle(buf, self.n_steps)
        if win.graph is not None:
            kernels.add_launches_later(win.launch_vector, buf.n_done + buf.discarded)
        for dst, src in zip(fields, global_from_blocks(buf.st.fields).unbind(0)):
            dst.copy_(src)
        tensors = [pos, u, w, alive, slots, pslot, slab_d, slab_valid, mid_pos, mid_u]
        for dst, name in zip(tensors, ("pos", "u", "w", "alive", "slots", "pslot", "slab_d", "slab_valid", "mid_pos",
                                       "mid_u")):
            dst.copy_(getattr(buf.st, name))
        _copy_tree(policy_state, buf.pstate)
        return (tuple(fields), *tensors, policy_state, bundle)


def make_dist_window(mesh, cfg: DistConfig, policy: SortPolicyConfig, n_steps: int, with_energies: bool = True,
                     health: HealthConfig | None = None, with_fault: bool = False):
    """The reference's window builder: a `DistWindowFn` of ``n_steps``
    steps on ``mesh`` = ``(sx, sy)``. Its call::

        (fields6, pos, u, w, alive, slots, pslot, slab_d, slab_valid,
         mid_pos, mid_u, policy_state, n_target, presort, resume, step0,
         rebalance_armed, fault_vec)
        -> (fields6, pos, u, w, alive, slots, pslot, slab_d, slab_valid,
            mid_pos, mid_u, policy_state, bundle)

    ``fields6`` are the six global (NX, NY, NZ) components, the particle
    arrays ``[SX, SY, ...]`` shard stacks (over ranks, a `PicMesh` with a
    rank grid, this rank's block of each). ``presort`` sorts every shard
    before the first step (a capacity growth's re-entry); ``resume``
    replays the carried mid-step snapshot in the first step (after a
    receive-side drop); ``rebalance_armed`` arms the imbalance halt;
    ``fault_vec`` fires only when the window is built ``with_fault``. The
    bundle has the reference's keys (`_dist_window_bundle`). The inputs are
    donated, as the reference's are: the result is written into the input
    tensors, which come back."""
    validate_shard_guard(cfg.local_grid, cfg.order)
    return DistWindowFn(as_pic_mesh(mesh), cfg, policy, n_steps, with_energies=with_energies, health=health,
                        with_fault=with_fault)

"""The batched ensemble engine: N independent single-device simulations of
one shape bucket, advanced together, with one host read a window.

Counterpart of `repro.pic.ensemble`, which vmaps the single-device window
over a stacked state. Here every window buffer holds its tensor once, with
a leading member axis (`_WindowBuffers` with ``members=B``), and member i's
tensors are the views ``t[i]``. A window step runs, for each member in
turn, the very step of the single-device driver (`_window_step`) on that
member's views, under the step's own guard ``~halted & (n_done <
target)``. On a CUDA device the bucket's step, each member's under its own
IF node, is captured once as one CUDA graph; a window is ``max_i k_i``
replays and one read of a ``[B, head + table]`` bundle. Each member's
kernels launch at the member's own shapes, so each member comes out
bit-equal to its own solo `Simulation` run.

Halt-and-grow stays on the host, per member. A member whose bins overflow
halts, and its remaining replays pass it by, while its siblings run to
their targets. The host then grows the shared capacity to fit the densest
cell of any member (at least doubling) and rebuilds each member:

* a halted member gets the single driver's growth, `global_sort`, so it
  stays step for step its own solo run;
* a sibling gets a re-bin without a permutation (`_rebin`): its particle
  order is kept and each bin's occupied slots stay a prefix, now with more
  zero padding, which the contractions add as nothing, so its trajectory
  stays its solo run's, bit for bit.

A capacity change makes new buffers and captures the step anew. The
bucket's captured windows live in a store (``windows``: one window per
member count) that a caller may share: the simulation service keeps one per
spec signature, so a repeat batch copies its members into the captured
buffers and replays, capturing nothing. A store's window serves one
ensemble at a time; the last to enter it owns its buffers.

Ensembles run without the health sentinel and the rollback ladder, as in
the reference: a halt other than an overflow raises. Every ``auto``
dispatcher key is resolved at the single-member shape, the one each
member's kernels run at.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch import kernels
from repro_torch import checkpoint as _checkpoint  # a module: checkpoint imports pic in turn
from repro_torch.core.binning import build_bins, cell_index, choose_capacity
from repro_torch.core.health import HALT_BIN_OVERFLOW, HALT_NAMES, HALT_NONE
from repro_torch.core.resort_policy import SortPolicyConfig, SortPolicyState, policy_init
from repro_torch.kernels import dispatch
from repro_torch.kernels.conditional import HostDecider
from repro_torch.pic.simulation import (
    PICConfig,
    PICState,
    _copy_tree,
    _energies,
    _same_shapes,
    _state_slab,
    _trees,
    _window_step,
    _WindowBuffers,
    capture_steps,
    consume_window_bundle,
    global_sort_device,
    init_state,
    parse_bundle,
)

__all__ = ["EnsembleSimulation", "EnsembleWindow", "member_bundle", "stack_trees", "unstack_tree"]


def stack_trees(*trees):
    """Stack same-shaped trees (dataclasses of tensors) along a new leading
    member axis; other leaves (a state's step) become a numpy array."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{f.name: stack_trees(*(getattr(t, f.name) for t in trees))
                                             for f in dataclasses.fields(first)})
    if first is None:
        return None
    return np.asarray(trees)


def unstack_tree(tree, n: int | None = None) -> list:
    """A stacked tree's members, as views."""
    if n is None:
        n = _first_tensor(tree).shape[0]
    return [_checkpoint.tree_member_slice(tree, i) for i in range(n)]


def _first_tensor(tree) -> torch.Tensor | None:
    if isinstance(tree, torch.Tensor):
        return tree
    for f in dataclasses.fields(tree) if dataclasses.is_dataclass(tree) else ():
        found = _first_tensor(getattr(tree, f.name))
        if found is not None:
            return found
    return None


def member_bundle(host: dict, i: int) -> dict:
    """Member i's part of an ensemble window's bundle, in the single
    driver's schema (scalars, and the per-step rows of its table), so the
    shared per-window accounting applies to it unchanged."""
    out = {k: v[i] for k, v in host.items() if k != "per_step"}
    out["per_step"] = {k: v[i] for k, v in host["per_step"].items()}
    return out


class EnsembleWindow:
    """One window of a bucket: its stacked buffers, each member's views of
    them, the step function and, on a CUDA device, the captured graph and
    the kernel launches each member's step recorded into it. It refers to
    no driver, so dropping it from its store frees its graph and its
    buffers."""

    def __init__(self, key: tuple, buffers: _WindowBuffers, step, n_members: int):
        self.key = key
        self.buffers = buffers
        self.members = [buffers.member(i) for i in range(n_members)]
        self.step = step
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: list[dict] = [{} for _ in range(n_members)]


class EnsembleSimulation:
    """Host driver of one shape bucket of N member simulations.

    ``members`` is a sequence of ``(fields, particles)`` initial conditions
    on one device; every member shares ``config`` (grid, order, dt, modes,
    backend and capacity) and the sort ``policy``. Members that need other
    shapes belong in other buckets (`repro_torch.api.make_ensemble` groups
    them by `spec_signature`). ``windows`` is the store of the bucket's
    captured windows (a dict keyed by member count); by default the
    ensemble keeps its own.

    `run` is windowed only: a window advances every member ``min(window,
    remaining_i)`` steps and makes one host read for the whole bucket.
    ``host_reads`` counts the bucket's reads: one a window, two more a
    capacity growth. ``graph_captures`` and ``window_builds`` count the
    windows captured and built (a window taken from a shared store is
    neither).
    """

    def __init__(self, members, config: PICConfig, policy: SortPolicyConfig | None = None, *, specs=None,
                 windows: dict | None = None):
        members = list(members)
        if not members:
            raise ValueError("an ensemble needs at least one member")
        self.n_members = len(members)
        self.specs = list(specs) if specs is not None else [None] * self.n_members
        if len(self.specs) != self.n_members:
            raise ValueError(f"{len(self.specs)} specs for {self.n_members} members")
        self.spec = next((s for s in self.specs if s is not None), None)
        self.policy = policy or SortPolicyConfig()
        self.config = config
        self.device = members[0][1].pos.device
        self.use_graphs = self.device.type == "cuda"
        self._state = stack_trees(*self._init_members(members))
        self.policy_state = stack_trees(*(policy_init(self.device) for _ in members))
        self._windows = {} if windows is None else windows
        self._window: EnsembleWindow | None = None
        self._prewarm_dispatch()

        self.host_step = np.zeros(self.n_members, np.int64)
        self.sorts = np.zeros(self.n_members, np.int64)
        self.rebuilds = np.zeros(self.n_members, np.int64)
        self.histories: list[list[dict]] = [[] for _ in range(self.n_members)]
        self.growths = {"capacity": 0}
        self.halts: dict[str, int] = {}
        self.windows = 0
        self.host_reads = 0
        self.window_builds = 0
        self.graph_captures = 0
        self.graph_setup_seconds = 0.0

    # -- construction ---------------------------------------------------------

    def _init_members(self, members) -> list[PICState]:
        """Each member's initial sort and bins at the shared capacity; if a
        member's initial binning overflows, the capacity first grows to fit
        the densest cell of all members (at least doubling)."""
        states = []
        for fields, particles in members:
            state, overflow = init_state(fields, particles, self.config)
            if overflow:
                needed = max(int(self._densest(p.pos, p.alive)) for _, p in members)
                new_cap = max(choose_capacity(needed), self.config.capacity * 2)
                self.config = dataclasses.replace(self.config, capacity=new_cap)
                return self._init_members(members)
            states.append(state)
        return states

    def _densest(self, pos: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
        """Occupancy of the densest cell of one member, or of any member of
        stacked ``[B, N, 3]`` positions, as a device scalar."""
        n_cells = self.config.grid.n_cells
        cells = cell_index(pos.reshape(-1, 3), self.config.grid.shape).reshape(alive.shape)
        if alive.dim() == 2:  # a bin per (member, cell)
            cells = cells + n_cells * torch.arange(alive.shape[0], device=cells.device)[:, None]
        counts = torch.zeros(alive.numel() // alive.shape[-1] * n_cells, dtype=torch.int64, device=pos.device)
        counts.index_add_(0, cells.reshape(-1), alive.reshape(-1).to(torch.int64))
        return counts.max()

    def _prewarm_dispatch(self) -> None:
        """Resolve the config's ``auto`` dispatch keys eagerly, at the
        single-member shape (each member's kernels run at it), so that the
        captured step finds the winner in the memo; again after a growth and
        a restore. A timing runs at the members' mean occupancy."""
        if self.config.backend != "auto":
            return
        p = self._state.particles
        fill = -(-int(torch.count_nonzero(p.alive)) // (self.n_members * self.config.grid.n_cells))
        dispatch.prewarm(dispatch.ops_for_modes(self.config.deposition, self.config.gather), device=self.device,
                         order=self.config.order, grid_shape=self.config.grid.shape,
                         capacity=self.config.capacity, dtype=p.pos.dtype, fill=fill)

    # -- state ------------------------------------------------------------------

    @property
    def state(self) -> PICState:
        """The stacked state (its step: each member's)."""
        return dataclasses.replace(self._state, step=self.host_step.copy())

    def member_state(self, i: int) -> PICState:
        """Member i's state: views of the bucket's tensors."""
        return dataclasses.replace(_checkpoint.tree_member_slice(self._state, i), step=int(self.host_step[i]))

    def member_policy_state(self, i: int) -> SortPolicyState:
        return _checkpoint.tree_member_slice(self.policy_state, i)

    def set_member(self, i: int, state: PICState, pstate: SortPolicyState) -> None:
        """Write a member's state and policy state, of the bucket's shapes,
        into slot i in place: a captured window stays valid."""
        _checkpoint.tree_member_set(self._state, i, state)
        _checkpoint.tree_member_set(self.policy_state, i, pstate)

    def _read(self, tensor: torch.Tensor):
        """Every device-to-host read of a run goes through here."""
        self.host_reads += 1
        return tensor.cpu()

    # -- the windowed run -----------------------------------------------------

    def run(self, n_steps=None, *, diagnostics_every: int | None = None, window: int | None = None,
            on_window=None) -> None:
        """Advance the members by ``n_steps``: an int (every member), a
        per-member sequence, or None (each member's spec), so that jobs of
        different lengths share a bucket. ``on_window(self, host)`` is called
        once per window bundle read, after its accounting and before any
        growth (the service streams from it)."""
        if n_steps is None:
            if any(s is None for s in self.specs):
                raise TypeError("run() needs n_steps (not every member has a spec)")
            per_steps = np.array([s.run.steps for s in self.specs], np.int64)
        elif np.ndim(n_steps) == 0:
            per_steps = np.full(self.n_members, int(n_steps), np.int64)
        else:
            per_steps = np.asarray(n_steps, np.int64)
            if per_steps.shape != (self.n_members,):
                raise ValueError(f"n_steps sequence has shape {per_steps.shape}; expected ({self.n_members},)")
        run = None if self.spec is None else self.spec.run
        if diagnostics_every is None:
            if all(s is not None for s in self.specs):
                diagnostics_every = max(s.run.diagnostics_every for s in self.specs)
            else:
                diagnostics_every = 0 if run is None else run.diagnostics_every
        if window is None:
            window = 16 if run is None else (run.window or 16)
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")

        target = self.host_step + per_steps
        while True:
            k = np.clip(target - self.host_step, 0, window)
            if not k.any():
                break
            host = self._enter_window(k, window, diagnostics_every)
            self._consume_bundle(host, diagnostics_every)
            if on_window is not None:
                on_window(self, host)
            codes = host["halt_code"]
            bad = [(i, int(c)) for i, c in enumerate(codes) if c not in (HALT_NONE, HALT_BIN_OVERFLOW)]
            if bad:
                i, c = bad[0]
                raise RuntimeError(f"ensemble member {i} halted with code {c} ({HALT_NAMES[c]}); "
                                   "the ensemble driver only recovers bin-overflow halts")
            overflowed = [i for i, c in enumerate(codes) if c == HALT_BIN_OVERFLOW]
            if overflowed:
                self.halts["bin_overflow"] = self.halts.get("bin_overflow", 0) + len(overflowed)
                self._grow_capacity(overflowed)

    def _window_for(self, with_energies: bool, n_diag: int) -> EnsembleWindow:
        """The bucket's window for these diagnostics: the current one, the
        store's (the members copied into its buffers) when its shapes are
        the bucket's, or one built on the bucket's own tensors (taken, not
        copied) and, on a CUDA device, captured."""
        names = ("n_moved", "n_alive") + (("field_energy", "kinetic_energy") if with_energies else ())
        key = (self.config, self.policy, names, n_diag, self.use_graphs)
        w = self._window
        if w is not None and w.key == key:
            return w
        w = self._windows.get(self.n_members)
        mine = _trees(self._state, self.policy_state)
        if w is not None and w.key == key and _same_shapes(_trees(w.buffers.state(), w.buffers.pstate), mine):
            for dst, src in zip(_trees(w.buffers.state(), w.buffers.pstate), mine):
                _copy_tree(dst, src)
        else:
            buf = _WindowBuffers(self._state, self.policy_state, names, n_diag, members=self.n_members)
            # (no closure over the driver: a stored window must not keep it alive)
            step = functools.partial(_window_step, config=self.config, policy=self.policy,
                                     with_energies=with_energies, health=None, with_fault=False)
            w = EnsembleWindow(key, buf, step, self.n_members)
            self.window_builds += 1
            if self.use_graphs:
                torch.cuda.synchronize(self.device)
                t0 = time.perf_counter()
                w.graph, w.launches = capture_steps(w.members, step)
                self.graph_captures += 1
                self.graph_setup_seconds += time.perf_counter() - t0
            self._windows[self.n_members] = w
        self._window = w
        self._state, self.policy_state = w.buffers.state(), w.buffers.pstate
        return w

    def _enter_window(self, k: np.ndarray, window: int, diagnostics_every: int) -> dict:
        """One window: member i makes up to k[i] steps; then the bucket's
        one bundle read. Returns the bundle with a member axis on every
        entry."""
        w = self._window_for(bool(diagnostics_every), window)
        buf = w.buffers
        buf.reset_counters()
        buf.enter_targets(k)
        k_max = int(k.max())
        if w.graph is not None:
            for _ in range(k_max):
                w.graph.replay()
        else:
            decider = HostDecider(self._read)
            for _ in range(k_max):
                for member in w.members:
                    w.step(member, decider=decider)
        self.windows += 1
        rows = self._read(buf.bundle(k_max)).numpy()
        parts = [parse_bundle(rows[i], buf.names, k_max, int(self.host_step[i])) for i in range(self.n_members)]
        if w.graph is not None:
            for launches, part in zip(w.launches, parts):
                kernels.add_launches(launches, part["n_done"])
        host = {key: np.array([p[key] for p in parts]) for key in parts[0] if key != "per_step"}
        host["per_step"] = {name: np.stack([p["per_step"][name] for p in parts]) for name in buf.names}
        return host

    def _consume_bundle(self, host: dict, diagnostics_every: int) -> None:
        for i in range(self.n_members):
            n_done, n_sorts, n_rebuilds = consume_window_bundle(
                member_bundle(host, i), int(self.host_step[i]), diagnostics_every, self.histories[i])
            self.host_step[i] += n_done
            self.sorts[i] += n_sorts
            self.rebuilds[i] += n_rebuilds

    # -- halt-and-grow --------------------------------------------------------

    def _grow_capacity(self, overflowed) -> None:
        """Grow the shared capacity to fit the densest cell of any member
        (with the standard headroom, at least doubling) and rebuild every
        member at it: the overflowed ones by `global_sort`, their siblings
        by `_rebin`. Two host reads; the next window is built anew."""
        overflowed = set(overflowed)
        p = self._state.particles
        needed = int(self._read(self._densest(p.pos, p.alive)))
        new_cap = max(choose_capacity(needed), self.config.capacity * 2)
        self.config = dataclasses.replace(self.config, capacity=new_cap)
        self.growths["capacity"] += 1
        rebuilt, overflows = [], []
        for i in range(self.n_members):
            st = self.member_state(i)
            st, overflow = global_sort_device(st, self.config) if i in overflowed else self._rebin(st)
            rebuilt.append(st)
            overflows.append(overflow)
        self._state = stack_trees(*rebuilt)
        self._window = None
        self._windows.pop(self.n_members, None)  # its shapes are gone: free it now
        overflow = int(self._read(torch.stack(overflows).max()))
        assert overflow == 0, "binning overflow persists after sizing capacity to the densest cell"
        self._prewarm_dispatch()  # the capacity is part of the dispatch key

    def _rebin(self, state: PICState) -> tuple[PICState, torch.Tensor]:
        """Re-bin one member at the current capacity without permuting its
        particles: each bin's occupied slots stay the same prefix, so the
        member's contractions, and its run, stay bit-identical. Returns the
        state and the overflow as a device scalar."""
        cells = cell_index(state.particles.pos, self.config.grid.shape)
        layout, overflow = build_bins(cells, state.particles.alive, n_cells=self.config.grid.n_cells,
                                      capacity=self.config.capacity)
        return dataclasses.replace(state, layout=layout, slab=_state_slab(state.particles, layout, self.config)), \
            overflow

    # -- diagnostics and checkpoints -----------------------------------------

    def diagnostics(self, i: int | None = None):
        """Member i's step, energies and live particles (the single
        driver's schema with its index), or every member's."""
        if i is None:
            return [self.diagnostics(j) for j in range(self.n_members)]
        st = self.member_state(i)
        field_e, kinetic_e = _energies(st, self.config)
        host = torch.stack([field_e.to(torch.float64), kinetic_e.to(torch.float64),
                            torch.sum(st.particles.alive).to(torch.float64)]).cpu()
        em, kinetic = float(host[0]), float(host[1])
        return {"member": i, "step": st.step, "field_energy": em, "kinetic_energy": kinetic,
                "total_energy": em + kinetic, "n_alive": int(host[2])}

    def save_member(self, i: int, path: str) -> None:
        """Member i as a standard single-driver checkpoint
        (`repro_torch.checkpoint.save_ensemble_member`)."""
        from repro_torch.checkpoint import save_ensemble_member

        save_ensemble_member(self, i, path)

    def restore_member(self, i: int, path: str) -> None:
        """A single-driver checkpoint into slot i
        (`repro_torch.checkpoint.restore_ensemble_member`)."""
        from repro_torch.checkpoint import restore_ensemble_member

        restore_ensemble_member(self, i, path)


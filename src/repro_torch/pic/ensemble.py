"""The batched ensemble engine: N independent single-device simulations of
one shape bucket, advanced together, with one host read a window.

Counterpart of `repro.pic.ensemble`, which vmaps the single-device window
over a stacked state. Here every window buffer holds its tensor once, with
a leading member axis (`_WindowBuffers` with ``members=B``), and member i's
tensors are the views ``t[i]``. A window step is one step over that axis
(`_window_step` on the bucket's buffers): `_pic_step` advances every
member at once, each kernel of the step launched once for the bucket (its
wrapper folds the members' cells into one launch, or, for the fused
gather, decodes each block's member), and each member keeps its new state
only while it is active, ``~halted & (n_done < target)``, as the
reference's vmapped step masks it. The global sort runs over every member
under one guard that some active member sorts. On a CUDA device the
bucket's step is captured once as one CUDA graph; a window is ``max_i
k_i`` replays and one read of a ``[B, head + table]`` bundle. Every kernel
and every torch op of the step gives each member the bits of its solo
step, and the energies are reduced on each member's own tensors, so each
member comes out bit-equal to its own solo `Simulation` run.

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

A window runs through a window callable (`make_ensemble_window_fn`,
`ensemble_run_window`'s signature). The first call copies the bucket's
state into the window's own buffers, and from then on the bucket's state
is those buffers, so a window copies nothing in or out, as a
`Simulation`'s does. A capacity change changes the shapes, so the callable
builds and captures a new window. The callable's store of captured
windows may be shared: the simulation service keeps one callable per spec
signature, so a repeat batch copies its members into the captured buffers
(the earlier batch's state, which it no longer reads) and replays,
capturing nothing.

Ensembles run without the health sentinel and the rollback ladder, as in
the reference: a halt other than an overflow raises. Every ``auto``
dispatcher key is resolved at the bucket's shape, ``batch`` = the member
count, the one the bucket's kernels run at.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import checkpoint as _checkpoint  # a module: checkpoint imports pic in turn
from repro_torch.core.binning import build_bins, cell_index, choose_capacity
from repro_torch.core.health import HALT_BIN_OVERFLOW, HALT_NAMES, HALT_NONE
from repro_torch.core.resort_policy import SortPolicyConfig, SortPolicyState, policy_init
from repro_torch.pic.simulation import (
    PICConfig,
    PICState,
    WindowFn,
    _energies,
    _state_slab,
    bundle_to_host,
    consume_window_bundle,
    global_sort_device,
    init_state,
    prewarm_dispatch,
)

__all__ = ["EnsembleSimulation", "make_ensemble_window_fn", "member_bundle", "stack_trees", "unstack_tree"]


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


def make_ensemble_window_fn(*, donate: bool = True) -> WindowFn:
    """A fresh ensemble-window callable, with `ensemble_run_window`'s
    signature and a store of captured windows of its own: the unit the
    simulation service caches and evicts per spec signature
    (`launch.sim_serve.ExecutableCache`). Dropping it frees its graphs and
    buffers. ``donate`` is its calls' default."""
    return WindowFn(members=True, donate=donate)


class EnsembleSimulation:
    """Host driver of one shape bucket of N member simulations.

    ``members`` is a sequence of ``(fields, particles)`` initial conditions
    on one device; every member shares ``config`` (grid, order, dt, modes,
    backend and capacity) and the sort ``policy``. Members that need other
    shapes belong in other buckets (`repro_torch.api.make_ensemble` groups
    them by `spec_signature`). ``window_fn`` is the window callable, as
    `make_ensemble_window_fn` makes it, whose store holds the bucket's
    captured windows; by default the ensemble makes its own.

    `run` is windowed only: a window advances every member ``min(window,
    remaining_i)`` steps and makes one host read for the whole bucket.
    ``host_reads`` counts the bucket's reads: one a window, two more a
    capacity growth. ``bucket_steps`` counts the bucket's steps (a window
    makes ``max_i`` of its members' steps; each launches every kernel of
    the step once). ``graph_captures`` and ``window_builds`` count the
    windows captured and built for this ensemble (a window already in the
    callable's store is neither).
    """

    def __init__(self, members, config: PICConfig, policy: SortPolicyConfig | None = None, *, specs=None,
                 window_fn: WindowFn | None = None):
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
        self._state = stack_trees(*self._init_members(members))
        self.policy_state = stack_trees(*(policy_init(self.device) for _ in members))
        self._window_fn = window_fn if window_fn is not None else make_ensemble_window_fn()
        self._window = None  # the window of the last call
        self._prewarm_dispatch()

        self.host_step = np.zeros(self.n_members, np.int64)
        self.sorts = np.zeros(self.n_members, np.int64)
        self.rebuilds = np.zeros(self.n_members, np.int64)
        self.histories: list[list[dict]] = [[] for _ in range(self.n_members)]
        self.growths = {"capacity": 0}
        self.halts: dict[str, int] = {}
        self.windows = 0
        self.host_reads = 0
        self.bucket_steps = 0
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
        """Resolve the config's ``auto`` dispatch keys eagerly at the
        bucket's shape, ``batch`` = the member count (its step runs each op
        once over the member axis), so that the captured step finds the
        batched winner in the memo; again after a growth and a restore. A
        timing runs at the members' mean occupancy."""
        prewarm_dispatch(self.config, self._state.particles, batch=self.n_members)

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

    def _enter_window(self, k: np.ndarray, window: int, diagnostics_every: int) -> dict:
        """One window through the window callable: member i makes up to
        k[i] steps; then the bucket's one bundle read. The bucket's state is
        then the window's buffers (as a `Simulation`'s is its window's), so
        the next call with the same window copies nothing in or out.
        Returns the bundle with a member axis on every entry."""
        fn = self._window_fn
        builds, captures, setup = fn.builds, fn.captures, fn.setup_seconds
        _, _, bundle = fn(dataclasses.replace(self._state, step=self.host_step), self.policy_state, self.config,
                          window, policy=self.policy, with_energies=bool(diagnostics_every), donate=True, n_target=k)
        self._window = fn.last
        self._state, self.policy_state = self._window.buffers.state(), self._window.buffers.pstate
        self.window_builds += fn.builds - builds
        self.graph_captures += fn.captures - captures
        self.graph_setup_seconds += fn.setup_seconds - setup
        self.windows += 1
        host = bundle_to_host(bundle, self._read)
        # the step ran while some member was active: in the first max_i
        # n_done_i replays
        self.bucket_steps += int(host["n_done"].max())
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
        self._window_fn.discard(self._window)  # its shapes are gone: free it now
        self._window = None
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


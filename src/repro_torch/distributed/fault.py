"""The chaos harness and the windowed-run supervisor of both drivers
(`Simulation` and `DistSimulation`). Counterpart of the PIC half of
`repro.distributed.fault`.

A declarative frozen `FaultSpec` (serialised on the `SimSpec`) drives a
deterministic fault: NaN into one field component or into the momenta, a
doubling of the weights that breaks charge conservation (all three injected
into the step's input on the device), a forced receive-side migration drop
(the distributed driver's), or a simulated crash on the host.
`run_supervised_windows` runs the windowed loop under the health sentinel:
a health halt rolls the window back to its entry snapshot and retries under
an escalating remedy ladder; an exception restores the latest autosave.

Over ranks (a `DistSimulation` spread over a process group) every rank
runs the same supervisor: each reads the same bundle, so each takes the
same rollback, remedy or growth; the rollback snapshot is each rank's own
block, copied on its device; an autosave is written by rank 0 from the
gathered global view, and a crash restores every rank from it.

The training loop's pieces of the reference's module are here too:
`FailureInjector` (raises `SimulatedFailure` at chosen steps),
`StragglerMonitor` (a step-time EMA that flags slow steps) and
`Supervisor`, the checkpoint/restart loop around a step function. Its
restore copies the checkpoint into the state it holds (the train step
updates that state in place), and it keeps the reference's quirk: a failure
before the first checkpoint replays from ``start_step`` on the state it
holds, advanced as it is. Over ranks (data-parallel training, one replica a
rank) the failure check at a step's start is agreed before the step's
collectives: any rank's injected failure makes every rank restore and
replay together.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import torch

from repro_torch.core.health import (
    HALT_INVARIANT,
    HALT_NAMES,
    HALT_NONFINITE,
    INVARIANT_NAMES,
    SimulationHealthError,
)

log = logging.getLogger("repro_torch.fault")


class SimulatedFailure(RuntimeError):
    pass


# -- the training loop's fault tolerance ----------------------------------------------------


class FailureInjector:
    """Raises SimulatedFailure at the given step numbers (test/chaos tool)."""

    def __init__(self, fail_at_steps=(), fail_once: bool = True):
        self.fail_at = set(fail_at_steps)
        self.fail_once = fail_once
        self.fired: set[int] = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and (not self.fail_once or step not in self.fired):
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    """Step-time EMA; flags steps slower than ``threshold`` x the EMA (a
    flagged step does not enter the EMA)."""

    threshold: float = 3.0
    ema: float | None = None
    alpha: float = 0.1
    flagged: int = 0

    def record(self, dt: float) -> bool:
        is_straggler = self.ema is not None and dt > self.threshold * self.ema
        if is_straggler:
            self.flagged += 1
            log.warning("straggler step: %.4fs vs EMA %.4fs", dt, self.ema)
        else:
            self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler


class Supervisor:
    """Checkpoint/restart wrapper around a step function.

    ``step_fn(state, step_idx) -> (state, metrics)``; the state is a tree
    of tensors that ``checkpoint_manager`` (a `checkpoint.CheckpointManager`)
    can save. Restores on any exception, up to ``max_restarts`` times, by
    copying the latest checkpoint into the state held.

    Over ``ranks`` (an `AxisRanks` whose ranks each hold the replicated
    state, or a `MeshRanks` layout whose ranks hold their blocks of the
    model axis and their slices of the data axis, and a checkpoint manager
    over the same ranks, which gathers and cuts them) every rank
    runs the same loop. At each step's start each rank's injector sets a flag
    in place of raising, and the flags are gathered over every rank (all
    D·M of a layout; one small collective a step, which reads the host):
    if any rank's fired, every rank restores
    and replays. An exception raised inside ``step_fn`` on one rank alone
    is not recovered: the ranks' collectives are then out of step, so it
    is raised, and the other ranks end with the group's error (its
    timeout, or a closed connection once the failing rank leaves)."""

    def __init__(
        self,
        step_fn: Callable,
        checkpoint_manager,
        *,
        save_every: int = 50,
        max_restarts: int = 10,
        injector: FailureInjector | None = None,
        straggler: StragglerMonitor | None = None,
        async_save: bool = True,
        ranks=None,
    ):
        self.step_fn = step_fn
        self.ranks = ranks
        self.ckpt = checkpoint_manager
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.injector = injector
        self.straggler = straggler or StragglerMonitor()
        self.async_save = async_save
        self.restarts = 0
        self.metrics_log: list[dict] = []

    def run(self, state, n_steps: int, *, start_step: int = 0):
        step = start_step
        while step < n_steps:
            try:
                if self.ranks is not None:
                    self._agree_failure(step)
                elif self.injector is not None:
                    self.injector.maybe_fail(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, step)
                dt = time.perf_counter() - t0
                is_straggler = self.straggler.record(dt)
                self.metrics_log.append(dict(metrics, step=step, step_time=dt, straggler=is_straggler))
                step += 1
                if step % self.save_every == 0 or step == n_steps:
                    self.ckpt.save(step, state, blocking=not self.async_save)
            except Exception as exc:  # noqa: BLE001 — any failure = node loss
                if self.ranks is not None and not isinstance(exc, SimulatedFailure):
                    raise
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                log.warning("step %d failed (%s); restoring latest checkpoint", step, exc)
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    # nothing saved yet: replay from start_step on the state held
                    step = start_step
                    continue
                state, step = self.ckpt.restore(state)
        self.ckpt.wait()
        return state, step

    def _agree_failure(self, step: int) -> None:
        """Raise `SimulatedFailure` on every rank if any rank's injector
        fires at ``step``."""
        failed = 0
        if self.injector is not None:
            try:
                self.injector.maybe_fail(step)
            except SimulatedFailure:
                failed = 1
        flags = self.ranks.values(torch.tensor(failed, dtype=torch.int64, device=self.ranks.device))
        if int(flags.amax()):
            raise SimulatedFailure(f"injected failure at step {step} on rank(s) "
                                   f"{[r for r, f in enumerate(flags.tolist()) if f]}")


# -- the simulation drivers' chaos harness -------------------------------------------------


# Injected fault kinds, encoded into a device vector [kind, step,
# component], so that arming a fault never recaptures the window's graph.
FAULT_NONE = 0
FAULT_NAN_FIELD = 1
FAULT_NAN_MOMENTUM = 2
FAULT_CHARGE_SCALE = 3
FAULT_RECV_DROP = 4

FIELD_COMPONENTS = ("ex", "ey", "ez", "bx", "by", "bz")

# "crash" is the host's alone (raises SimulatedFailure between windows)
FAULT_KINDS = {
    "nan_field": FAULT_NAN_FIELD,
    "nan_momentum": FAULT_NAN_MOMENTUM,
    "charge_scale": FAULT_CHARGE_SCALE,
    "recv_drop": FAULT_RECV_DROP,
    "crash": FAULT_NONE,
}

GRAPH_FAULT_KINDS = frozenset(k for k in FAULT_KINDS if k != "crash")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A fault to inject (the reference's fields and checks).

    ``kind``: ``nan_field`` (NaN into ``component`` before the step),
    ``nan_momentum`` (NaN into the momenta), ``charge_scale`` (the weights
    doubled), ``recv_drop`` (the distributed driver's migration drop),
    ``crash`` (`SimulatedFailure` on the host before the window holding
    ``step``). ``step``: the step counter at which it fires; an injected
    fault corrupts the input of step ``step + 1``, the step the sentinel
    reports. ``count``: how many times it fires, 0 for every time."""

    kind: str = "nan_field"
    step: int = 0
    component: str = "ez"
    count: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {sorted(FAULT_KINDS)}")
        if self.component not in FIELD_COMPONENTS:
            raise ValueError(f"unknown field component {self.component!r}")
        if self.step < 0 or self.count < 0:
            raise ValueError("FaultSpec step and count must be >= 0")

    @staticmethod
    def from_dict(d: dict) -> "FaultSpec":
        names = {f.name for f in dataclasses.fields(FaultSpec)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"FaultSpec has unknown keys {sorted(unknown)}")
        return FaultSpec(**d)


def no_fault_vec(device=None) -> torch.Tensor:
    """A fault vector that never fires (step -1 matches no counter)."""
    return torch.tensor([FAULT_NONE, -1, 0], dtype=torch.int64, device=device)


def _fires(kind: int, step_count, fault_vec) -> torch.Tensor:
    return (fault_vec[0] == kind) & (step_count == fault_vec[1])


def inject_fields(fields, step_count, fault_vec):
    """The six field tensors (`FIELD_COMPONENTS` order), one of them NaN
    where a ``nan_field`` fault fires at ``step_count`` (a 0-d tensor): a
    masked select, the inputs' values unchanged otherwise."""
    fire = _fires(FAULT_NAN_FIELD, step_count, fault_vec)
    return tuple(torch.where(fire & (fault_vec[2] == i), torch.full_like(f, float("nan")), f)
                 for i, f in enumerate(fields))


def inject_momenta(u, step_count, fault_vec):
    """Momenta, NaN where a ``nan_momentum`` fault fires."""
    return torch.where(_fires(FAULT_NAN_MOMENTUM, step_count, fault_vec), torch.full_like(u, float("nan")), u)


def inject_weights(w, step_count, fault_vec):
    """Weights, doubled where a ``charge_scale`` fault fires."""
    return torch.where(_fires(FAULT_CHARGE_SCALE, step_count, fault_vec), w * 2.0, w)


def injected_recv_drop(step_count, fault_vec):
    """int32 1 where a ``recv_drop`` fault fires, else 0."""
    return _fires(FAULT_RECV_DROP, step_count, fault_vec).to(torch.int32)


class PICFaultInjector:
    """The host side of a `FaultSpec`: arms the fault vector for the windows
    that cover ``spec.step``, raises the simulated crash, and retires the
    fault once it has fired ``spec.count`` times, so that a retried window
    runs clean."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.remaining = spec.count if spec.count > 0 else None  # None: every time
        self.fired = 0

    def _armed(self) -> bool:
        return self.remaining is None or self.remaining > 0

    def _consume(self) -> None:
        self.fired += 1
        if self.remaining is not None:
            self.remaining -= 1

    def window_vec(self, host_step: int, k: int) -> torch.Tensor | None:
        """The (CPU, int64) fault vector of a window of k steps from
        ``host_step``, or None when no injected fault is armed for it."""
        if self.spec.kind not in GRAPH_FAULT_KINDS or not self._armed():
            return None
        if not host_step <= self.spec.step < host_step + k:
            return None
        comp = FIELD_COMPONENTS.index(self.spec.component)
        return torch.tensor([FAULT_KINDS[self.spec.kind], self.spec.step, comp], dtype=torch.int64)

    def maybe_crash(self, host_step: int, k: int) -> None:
        if self.spec.kind != "crash" or not self._armed():
            return
        if host_step <= self.spec.step < host_step + k:
            self._consume()
            raise SimulatedFailure(f"injected crash before window at step {host_step}")

    def note_halt(self, code: int, halt_step: int) -> None:
        """Count a halt at step ``spec.step + 1`` (the step whose input the
        fault corrupted) as one firing of the armed fault."""
        if self.spec.kind in GRAPH_FAULT_KINDS and self._armed() and halt_step == self.spec.step + 1:
            self._consume()


def run_supervised_windows(sim, n_steps: int, diagnostics_every: int, window: int, *, autosave_every: int = 0,
                           autosave_path: str = "") -> None:
    """Run ``n_steps`` of the windowed driver under fault supervision.

    ``sim`` exposes the reference's hooks: ``_take_snapshot`` and
    ``_restore_snapshot`` (the window's entry state), ``_enter_window``
    (run one window, return its host bundle), ``_consume_bundle`` (commit a
    window), ``_handle_halt`` (grow and continue after an overflow),
    ``_remedy_sort`` and ``_demote_backend`` (rungs of the ladder), and the
    counters ``halts``, ``retries``, ``restarts``, ``discarded_steps``.

    * A health halt (``HALT_NONFINITE``, ``HALT_INVARIANT``) restores the
      snapshot and retries: level 1 halves the window, level 2 forces a
      global sort, each level from 3 demotes the kernel backend one rung;
      past ``max_retries``, or with nothing left to demote to, it raises
      `SimulationHealthError` naming the halt, its step and the invariant.
    * An overflow halt goes to the driver's grow-and-continue handler.
    * An exception restores the latest autosave (``autosave_every`` makes a
      `SimCheckpointer`) and resumes, up to ``max_restarts`` times.
    """
    health = sim._health
    inj = sim.fault_injector
    max_retries = health.max_retries if health is not None else 3
    max_restarts = health.max_restarts if health is not None else 3

    ckpt = None
    if autosave_every:
        from repro_torch.checkpoint import SimCheckpointer

        ckpt = SimCheckpointer(sim, autosave_path, every=autosave_every)
        ckpt.maybe_save(sim._host_step, force=True)

    target = sim._host_step + n_steps
    retry_target = 0  # nonzero: the ladder's level 1 capped the window
    while True:
        try:
            while sim._host_step < target:
                k = min(window, target - sim._host_step)
                if retry_target:
                    k = min(k, retry_target)
                if inj is not None:
                    inj.maybe_crash(sim._host_step, k)
                fault_vec = inj.window_vec(sim._host_step, k) if inj is not None else None
                snap = sim._take_snapshot() if health is not None else None
                host = sim._enter_window(k, window, diagnostics_every, fault_vec)
                code = int(host.get("halt_code", 0))

                if code in (HALT_NONFINITE, HALT_INVARIANT):
                    sim._restore_snapshot(snap)
                    name = HALT_NAMES[code]
                    sim.halts[name] = sim.halts.get(name, 0) + 1
                    if inj is not None:
                        inj.note_halt(code, int(host.get("halt_step", -1)))
                    sim.retries += 1
                    sim._remedy_level += 1
                    level = sim._remedy_level
                    exhausted = level > max_retries
                    if not exhausted and level >= 3:
                        exhausted = not sim._demote_backend()
                    if exhausted:
                        raise SimulationHealthError(
                            halt=name,
                            step=int(host.get("halt_step", -1)),
                            invariant=INVARIANT_NAMES[int(host.get("halt_inv", 0))],
                            measured=float(host.get("halt_measured", float("nan"))),
                            reference=float(host.get("halt_reference", float("nan"))),
                            retries=sim.retries,
                        )
                    if level == 1:
                        retry_target = max(1, k // 2)
                    elif level == 2:
                        sim._remedy_sort()
                    log.warning("health halt %s at step %s: rollback, remediation level %d", name,
                                host.get("halt_step"), level)
                    continue

                n_done = sim._consume_bundle(host, diagnostics_every)
                sim.discarded_steps += int(host.get("n_discarded", 0))
                sim._remedy_level = 0
                retry_target = 0
                if code:
                    name = HALT_NAMES[code]
                    sim.halts[name] = sim.halts.get(name, 0) + 1
                    if inj is not None:
                        inj.note_halt(code, int(host.get("halt_step", -1)))
                    sim._handle_halt(code, host)
                elif n_done < k:
                    raise RuntimeError("windowed driver made no progress without a halt")
                if ckpt is not None:
                    ckpt.maybe_save(sim._host_step)
            break
        except SimulationHealthError:
            raise
        except Exception as exc:  # noqa: BLE001 — any failure is a lost node: restore and resume
            if ckpt is None:
                raise
            sim.restarts += 1
            if sim.restarts > max_restarts:
                raise
            restarts = sim.restarts
            log.warning("window at step %d failed (%s); restoring latest checkpoint", sim._host_step, exc)
            from repro_torch.checkpoint import restore_simulation

            restore_simulation(sim, ckpt.latest_path())
            # the checkpoint predates the crash: keep the live restart count
            sim.restarts = restarts
            sim._remedy_level = 0
            retry_target = 0
    if ckpt is not None:
        ckpt.maybe_save(sim._host_step, force=True)

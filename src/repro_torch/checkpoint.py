"""Checkpoints of the single-device driver, in the reference's format.

Counterpart of the single-device part of `repro.api.facade`'s
``save_simulation`` / ``restore_simulation`` / ``load_simulation``. A
checkpoint is a directory holding

* ``arrays.npz``: the leaves of ``{"policy_state": ..., "state": ...}`` as
  ``a0``, ``a1``, ..., in the reference's flattening order and under its
  leaf names (``"['state']/.fields/.ex"``): the policy state, then fields,
  particles, layout, ``step`` (an int32 scalar) and, when the step carries
  one, the slab;
* ``checkpoint.json``: the driver kind, the spec (`SimSpec.to_dict`), the
  host counters and policy, the leaf names and a CRC32 of each leaf.

It is written to a temporary directory and renamed into place, so a crash
leaves the old checkpoint or the new one. A run moves between the two
packages in mid-flight: a checkpoint that one writes, the other loads.

`SimCheckpointer` keeps a rolling set of step-stamped checkpoints for the
supervisor's autosave (`Simulation.run(autosave_every=N)`), and
`clean_stale_tmp` sweeps what killed writers left behind.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib

import numpy as np
import torch

from repro_torch.core.binning import BinnedLayout, BinSlab
from repro_torch.core.resort_policy import SortPolicyState
from repro_torch.pic.grid import FieldState
from repro_torch.pic.plasma import ParticleState
from repro_torch.pic.simulation import state_from_reference

__all__ = ["SimCheckpointer", "clean_stale_tmp", "load_simulation", "restore_simulation", "save_simulation"]

_ARRAYS = "arrays.npz"
_META = "checkpoint.json"


def _leaf(path: tuple[str, ...]) -> str:
    """The reference's leaf name: a dict key, then attribute names."""
    return "/".join([f"['{path[0]}']"] + [f".{p}" for p in path[1:]])


def _flatten(sim) -> list[tuple[str, torch.Tensor | int]]:
    """(name, leaf) pairs of the driver's policy state and state, in the
    reference's order (dict keys sorted, dataclass fields in order)."""
    out = [(_leaf(("policy_state", f.name)), getattr(sim.policy_state, f.name))
           for f in dataclasses.fields(SortPolicyState)]
    s = sim.state
    for part, cls in (("fields", FieldState), ("particles", ParticleState), ("layout", BinnedLayout)):
        out += [(_leaf(("state", part, f.name)), getattr(getattr(s, part), f.name)) for f in dataclasses.fields(cls)]
    out.append((_leaf(("state", "step")), s.step))
    if s.slab is not None:
        out += [(_leaf(("state", "slab", f.name)), getattr(s.slab, f.name)) for f in dataclasses.fields(BinSlab)]
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    return leaf.detach().cpu().numpy()


def _crc(a: np.ndarray) -> str:
    return "%08x" % zlib.crc32(np.ascontiguousarray(a).tobytes())


def _write_dir(path: str, names: list[str], host: list[np.ndarray], meta: dict) -> None:
    """Atomic checkpoint directory write: a temporary directory renamed into
    place; an old checkpoint is moved aside first and deleted last."""
    tmp = path + f".tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _ARRAYS), **{f"a{i}": a for i, a in enumerate(host)})
    with open(os.path.join(tmp, _META), "w") as f:
        json.dump(dict(meta, names=names, checksums=[_crc(a) for a in host]), f, indent=1)
    old = path + f".old-{os.getpid()}"
    if os.path.exists(old):
        shutil.rmtree(old)
    had_old = os.path.exists(path)
    if had_old:
        os.rename(path, old)
    os.rename(tmp, path)
    if had_old:
        shutil.rmtree(old)


def _read_meta(path: str) -> dict:
    with open(os.path.join(path, _META)) as f:
        return json.load(f)


def _read_dir(path: str) -> tuple[dict, dict]:
    """(name -> numpy array, metadata), with every checksum verified: a
    truncated file or a changed byte fails here."""
    try:
        meta = _read_meta(path)
        with np.load(os.path.join(path, _ARRAYS)) as data:
            host = [np.asarray(data[f"a{i}"]) for i in range(len(meta["names"]))]
    except Exception as exc:
        raise ValueError(f"corrupt or truncated checkpoint at {path}: {exc}") from exc
    if "checksums" in meta:
        sums, names = meta["checksums"], meta["names"]
        if len(sums) != len(host):
            raise ValueError(f"corrupt checkpoint at {path}: manifest lists {len(sums)} checksums for "
                             f"{len(host)} arrays")
        bad = [names[i] for i, (a, c) in enumerate(zip(host, sums)) if _crc(a) != c]
        if bad:
            raise ValueError(f"corrupt checkpoint at {path}: checksum mismatch for {bad}")
    return dict(zip(meta["names"], host)), meta


def save_simulation(sim, path: str) -> None:
    """Checkpoint a single-device `Simulation` to `path`."""
    pairs = _flatten(sim)
    st = sim.host_policy.state
    scalars = {
        "sorts": sim.sorts,
        "rebuilds": sim.rebuilds,
        "host_step": sim._host_step,
        "capacity": sim.config.capacity,
        "host_policy": {
            "steps_since_sort": st.steps_since_sort,
            "rebuilds_since_sort": st.rebuilds_since_sort,
            "baseline_perf": st.baseline_perf,
            "perf_ema": st.perf_ema,
        },
        "history": sim.history,
        "growths": dict(sim.growths),
        "halts": dict(sim.halts),
        "retries": sim.retries,
        "restarts": sim.restarts,
        "discarded_steps": sim.discarded_steps,
    }
    meta = {"driver": "single", "spec": None if sim.spec is None else sim.spec.to_dict(), "scalars": scalars}
    _write_dir(path, [n for n, _ in pairs], [_host(leaf) for _, leaf in pairs], meta)


def _shape_ok(name: str, saved: tuple, tmpl: tuple) -> bool:
    """The reference's guards: the capacity may differ (it grows mid-run and
    the checkpoint's wins); every other dimension is fixed by the grid and
    the plasma."""
    if "fields" in name:
        return saved == tmpl
    if "slab" in name:            # (n_cells, capacity, ...)
        return saved[:1] == tmpl[:1] and saved[2:] == tmpl[2:]
    if "slots" in name and "particle_slot" not in name:
        return saved[:1] == tmpl[:1]  # (n_cells, capacity)
    return saved == tmpl


def restore_simulation(sim, path: str) -> None:
    """Restore a checkpoint into a compatible driver: the same grid and
    particle count; the capacity is the checkpoint's. The window's captured
    step is dropped (the next window captures anew)."""
    arrays, meta = _read_dir(path)
    if meta["driver"] != "single":
        raise ValueError(f"checkpoint was written by the {meta['driver']!r} driver; the port runs 'single'")
    template = _flatten(sim)
    for name, leaf in template:
        if name not in arrays:
            continue
        saved, tmpl = tuple(arrays[name].shape), () if isinstance(leaf, int) else tuple(leaf.shape)
        if not _shape_ok(name, saved, tmpl):
            raise ValueError(f"checkpoint leaf {name} has shape {saved} but this driver implies {tmpl} — the "
                             "checkpoint belongs to a different grid/mesh/plasma")
    missing = [name for name, _ in template if name not in arrays]
    if missing:
        raise ValueError(f"checkpoint is missing leaves {missing[:4]}... ({len(missing)} total)")

    scal = meta["scalars"]
    sim.config = dataclasses.replace(sim.config, capacity=scal["capacity"])
    # "['state']/.fields/.ex" -> "fields.ex", "['policy_state']/.proxy_ema" -> "policy.proxy_ema"
    short = {name: ".".join(["policy" if name.startswith("['policy_state']") else ""]
                            + [p[1:] for p in name.split("/")[1:]]).lstrip(".") for name in arrays}
    sim.state, sim.policy_state = state_from_reference({short[n]: a for n, a in arrays.items()}, sim.config,
                                                       sim.device)
    sim.sorts = scal["sorts"]
    sim.rebuilds = scal["rebuilds"]
    sim._host_step = scal["host_step"]
    sim.history = list(scal["history"])
    sim.growths = dict(scal.get("growths", sim.growths))
    sim.halts = dict(scal.get("halts", {}))
    sim.retries = int(scal.get("retries", 0))
    sim.restarts = int(scal.get("restarts", 0))
    sim.discarded_steps = int(scal.get("discarded_steps", 0))
    sim._remedy_level = 0
    hp = scal["host_policy"]
    st = sim.host_policy.state
    st.steps_since_sort, st.rebuilds_since_sort = hp["steps_since_sort"], hp["rebuilds_since_sort"]
    st.baseline_perf, st.perf_ema = hp["baseline_perf"], hp["perf_ema"]
    # the restored capacity is part of the dispatch key: resolve it before
    # the next window captures its step
    sim._prewarm_dispatch()


def load_simulation(path: str, device=None):
    """Rebuild the driver a checkpoint describes from its embedded spec, on
    ``device`` (default ``cuda``, as `make_simulation`), and restore it."""
    from repro_torch.api.facade import make_simulation
    from repro_torch.api.spec import SimSpec

    meta = _read_meta(path)
    if meta.get("spec") is None:
        raise ValueError("checkpoint has no embedded SimSpec; build the driver yourself and call "
                         "restore_simulation(sim, path)")
    sim = make_simulation(SimSpec.from_dict(meta["spec"]), device=device)
    restore_simulation(sim, path)
    return sim


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def clean_stale_tmp(directory: str) -> list[str]:
    """Remove the ``*.tmp-<pid>`` and ``*.old-<pid>`` entries that killed
    writers left (a clean exit leaves none); those of a live pid stay.
    Returns the removed paths."""
    removed = []
    if not os.path.isdir(directory):
        return removed
    for name in os.listdir(directory):
        for marker in (".tmp-", ".old-"):
            if marker in name:
                suffix = name.rsplit(marker, 1)[1]
                if suffix.isdigit() and _pid_alive(int(suffix)):
                    continue
                path = os.path.join(directory, name)
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    try:
                        os.remove(path)
                    except OSError:
                        pass
                removed.append(path)
                break
    return removed


class SimCheckpointer:
    """Rolling autosave of a driver: `save_simulation` directories
    ``step_<step:09d>`` under one root, the newest ``keep`` kept, and
    `latest_path` for a restore. Stale temporaries are swept at
    construction.

    `maybe_save(step)` saves once at least ``every`` steps have passed since
    the last save: windows rarely end on a multiple, so the cadence is
    "every N, or the first window boundary after it"."""

    def __init__(self, sim, directory: str, *, every: int, keep: int = 2):
        if every <= 0:
            raise ValueError(f"autosave interval must be positive, got {every}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.sim = sim
        self.directory = directory or "checkpoints"
        self.every = every
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        clean_stale_tmp(self.directory)
        self._last: int | None = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def _steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if not name.startswith("step_") or ".tmp-" in name or ".old-" in name:
                continue
            try:
                out.append(int(name[len("step_"):]))
            except ValueError:
                continue
        return sorted(out)

    def latest_path(self) -> str:
        steps = self._steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return self._path(steps[-1])

    def maybe_save(self, step: int, force: bool = False) -> bool:
        if not force and self._last is not None and step - self._last < self.every:
            return False
        if not force and self._last is None:
            self._last = step  # the baseline: count `every` steps from here
            return False
        save_simulation(self.sim, self._path(step))
        self._last = step
        for old in self._steps()[: -self.keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)
        return True

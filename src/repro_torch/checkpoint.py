"""Checkpoints of the drivers, in the reference's format.

Counterpart of `repro.api.facade`'s ``save_simulation`` /
``restore_simulation`` / ``load_simulation``. A checkpoint is a directory
holding

* ``arrays.npz``: the leaves of ``{"policy_state": ..., "state": ...}`` as
  ``a0``, ``a1``, ..., in the reference's flattening order and under its
  leaf names. The single-device driver's (``"['state']/.fields/.ex"``): the
  policy state, then fields, particles, layout, ``step`` (an int32 scalar)
  and, when the step carries one, the slab. The distributed driver's
  (``"['state']/['pos']"``): the policy state, then its state dict's keys
  in sorted order, the fields on the global grid (``"['state']/['fields']/
  [0]"`` ... ``[5]``) and every particle, bin and slab tensor with its two
  shard axes, the mid-step replay snapshot included;
* ``checkpoint.json``: the driver kind (``single`` or ``dist``), the spec
  (`SimSpec.to_dict`), the host counters and policy (the distributed
  driver's also its mesh, ``n_local``, ``mig_cap``, re-entry flags,
  communication totals and arming flag), the leaf names and a CRC32 of
  each leaf (`array_checksums`, checked on load by `verify_checksums`).

It is written to a temporary directory and renamed into place, so a crash
leaves the old checkpoint or the new one. A run moves between the two
packages in mid-flight: a checkpoint that one writes, the other loads.

A distributed driver over ranks saves collectively: every rank's block is
gathered, rank 0 writes the global view in the format above (the one
process's checkpoint of the same run, array for array), and every rank
waits for the write. Every rank restores from the same directory and keeps
its block.

`SimCheckpointer` keeps a rolling set of step-stamped checkpoints for the
supervisor's autosave (`Simulation.run(autosave_every=N)`), and
`clean_stale_tmp` sweeps what killed writers left behind.

`CheckpointManager` is the reference's step-stamped store of a tree of
tensors (nested dicts, tuples and lists), which `grad.fit` keeps its
{params, optimizer} state in and the LM `Supervisor` its train state:
``step_XXXXXXXXX/arrays.npz`` and ``manifest.json`` (leaf names, shapes,
dtypes, CRC32s), a ``LATEST`` file, atomic renames, keep-k garbage
collection and a background-thread save. Leaf names are the strings JAX's
key paths give for the same trees (``['opt']/['mu']/['laser.a0']``), so a
fit saved by either package resumes in the other.

An ensemble member (`repro_torch.pic.ensemble.EnsembleSimulation`) is saved
as a standard single-driver checkpoint (`save_ensemble_member`, loadable by
`load_simulation` in either package) and restored into an ensemble slot
(`restore_ensemble_member`), in place in the bucket's stacked tensors
(`tree_member_slice`, `tree_member_set`), so that a captured window stays
valid.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.core.binning import BinnedLayout, BinSlab
from repro_torch.core.resort_policy import SortPolicyState
from repro_torch.pic.grid import FieldState
from repro_torch.pic.plasma import ParticleState
from repro_torch.pic.simulation import state_from_reference

__all__ = ["CheckpointManager", "SimCheckpointer", "array_checksums", "clean_stale_tmp", "load_simulation",
           "restore_ensemble_member", "restore_simulation", "save_ensemble_member", "save_simulation",
           "tree_member_set", "tree_member_slice", "verify_checksums"]

_ARRAYS = "arrays.npz"
_META = "checkpoint.json"


def _leaf(path: tuple[str, ...]) -> str:
    """The reference's leaf name: a dict key, then attribute names."""
    return "/".join([f"['{path[0]}']"] + [f".{p}" for p in path[1:]])


def _flatten(s, policy_state) -> list[tuple[str, torch.Tensor | int]]:
    """(name, leaf) pairs of a policy state and a state, in the reference's
    order (dict keys sorted, dataclass fields in order)."""
    out = [(_leaf(("policy_state", f.name)), getattr(policy_state, f.name))
           for f in dataclasses.fields(SortPolicyState)]
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


def array_checksums(host_leaves) -> list[str]:
    """crc32 hex digest per array (over the raw bytes, C order): the
    reference's manifest checksums."""
    return ["%08x" % zlib.crc32(np.ascontiguousarray(a).tobytes()) for a in host_leaves]


def verify_checksums(arrays, checksums, names, where: str) -> None:
    """Raise ValueError naming every array whose bytes do not match the
    manifest checksum (bit rot, truncation, partial write), with the
    reference's messages."""
    if len(arrays) != len(checksums):
        raise ValueError(f"corrupt checkpoint at {where}: manifest lists {len(checksums)} checksums for "
                         f"{len(arrays)} arrays")
    bad = [names[i] if i < len(names) else f"a{i}"
           for i, (got, want) in enumerate(zip(array_checksums(arrays), checksums)) if got != want]
    if bad:
        raise ValueError(f"corrupt checkpoint at {where}: checksum mismatch for {bad}")


def _write_dir(path: str, names: list[str], host: list[np.ndarray], meta: dict) -> None:
    """Atomic checkpoint directory write: a temporary directory renamed into
    place; an old checkpoint is moved aside first and deleted last."""
    tmp = path + f".tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _ARRAYS), **{f"a{i}": a for i, a in enumerate(host)})
    with open(os.path.join(tmp, _META), "w") as f:
        json.dump(dict(meta, names=names, checksums=array_checksums(host)), f, indent=1)
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
        verify_checksums(host, meta["checksums"], meta["names"], path)
    return dict(zip(meta["names"], host)), meta


def _flatten_dist(sim) -> list[tuple[str, torch.Tensor]]:
    """(name, leaf) pairs of a `DistSimulation`, in the reference's order:
    its state dict's keys sorted, the fields as six global grids; over
    ranks, the whole mesh's (a collective)."""
    state = sim.global_state()
    out = [(_leaf(("policy_state", f.name)), getattr(sim.policy_state, f.name))
           for f in dataclasses.fields(SortPolicyState)]
    for key in sorted(state):
        if key == "fields":
            out += [(f"['state']/['fields']/[{i}]", f) for i, f in enumerate(state["fields"])]
        else:
            out.append((f"['state']/['{key}']", state[key]))
    return out


def _is_dist(sim) -> bool:
    from repro_torch.pic.dist_simulation import DistSimulation

    return isinstance(sim, DistSimulation)


def save_simulation(sim, path: str) -> None:
    """Checkpoint a driver (`Simulation` or `DistSimulation`) to `path`."""
    distributed = _is_dist(sim)
    pairs = _flatten_dist(sim) if distributed else _flatten(sim.state, sim.policy_state)
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
    if distributed:
        scalars.update(
            mig_cap=sim.config.mig_cap,
            n_local=sim.n_local,
            mesh_shape=[sim.sx, sim.sy],  # the live split: a rebalance may have changed it
            mig_recv_dropped=sim.mig_recv_dropped,
            pending_presort=bool(sim._pending_presort),
            pending_resume=bool(sim._pending_resume),
            comm_stats=dict(sim.comm_stats),
            rebalance_armed=bool(sim._rebalance_armed),
        )
    meta = {"driver": "dist" if distributed else "single", "spec": None if sim.spec is None else sim.spec.to_dict(),
            "scalars": scalars}
    if _writes(sim):
        _write_dir(path, [n for n, _ in pairs], [_host(leaf) for _, leaf in pairs], meta)
    if distributed and sim.ranks is not None:
        sim.ranks.barrier()  # no rank reads the directory before it is in place


def _writes(sim) -> bool:
    """Whether this process writes the driver's checkpoints (rank 0 of a
    driver over ranks, any other driver)."""
    return getattr(sim, "is_writer", True)


def _shape_ok(name: str, saved: tuple, tmpl: tuple, distributed: bool = False) -> bool:
    """The reference's guards: the capacity may differ (it grows mid-run and
    the checkpoint's wins), and so may a distributed shard's particle count
    (``n_local``); every other dimension is fixed by the grid, the mesh and
    the plasma."""
    if "fields" in name:
        return saved == tmpl
    if distributed:
        if "slab" in name:        # (sx, sy, n_cells, capacity, ...)
            return saved[:3] == tmpl[:3] and saved[4:] == tmpl[4:]
        if "slots" in name:       # (sx, sy, n_cells, capacity)
            return saved[:3] == tmpl[:3]
        return saved[:2] == tmpl[:2] and saved[3:] == tmpl[3:]  # (sx, sy, n_local, ...)
    if "slab" in name:            # (n_cells, capacity, ...)
        return saved[:1] == tmpl[:1] and saved[2:] == tmpl[2:]
    if "slots" in name and "particle_slot" not in name:
        return saved[:1] == tmpl[:1]  # (n_cells, capacity)
    return saved == tmpl


def _check_leaves(arrays: dict, template: list, distributed: bool = False) -> None:
    """Every leaf of ``template`` is in the checkpoint, at a shape that fits
    (`_shape_ok`)."""
    for name, leaf in template:
        if name not in arrays:
            continue
        saved, tmpl = tuple(arrays[name].shape), () if isinstance(leaf, int) else tuple(leaf.shape)
        if not _shape_ok(name, saved, tmpl, distributed):
            raise ValueError(f"checkpoint leaf {name} has shape {saved} but this driver implies {tmpl} — the "
                             "checkpoint belongs to a different grid/mesh/plasma")
    missing = [name for name, _ in template if name not in arrays]
    if missing:
        raise ValueError(f"checkpoint is missing leaves {missing[:4]}... ({len(missing)} total)")


def _short_names(arrays: dict) -> dict:
    """The checkpoint's arrays under `state_from_reference`'s names:
    "['state']/.fields/.ex" -> "fields.ex", "['policy_state']/.proxy_ema"
    -> "policy.proxy_ema"."""
    return {".".join(["policy" if name.startswith("['policy_state']") else ""]
                     + [p[1:] for p in name.split("/")[1:]]).lstrip("."): a for name, a in arrays.items()}


def _restore_dist(sim, arrays: dict, scal: dict) -> None:
    """Install a distributed checkpoint's state and scalars into ``sim``."""
    if list(scal["mesh_shape"]) != [sim.sx, sim.sy]:
        raise ValueError(f"checkpoint was written on a {scal['mesh_shape'][0]}x{scal['mesh_shape'][1]} mesh but this "
                         f"driver runs {sim.sx}x{sim.sy}")
    # a checkpoint without the replay snapshot: zeros (no replay is pending
    # at a checkpoint boundary)
    for mid, src in (("mid_pos", "pos"), ("mid_u", "u")):
        arrays.setdefault(f"['state']/['{mid}']", np.zeros_like(arrays.get(f"['state']/['{src}']", np.zeros(0))))
    _check_leaves(arrays, _flatten_dist(sim), distributed=True)
    sim.config = dataclasses.replace(sim.config, capacity=scal["capacity"], mig_cap=scal["mig_cap"])
    sim.n_local = scal["n_local"]
    sim.mig_recv_dropped = scal["mig_recv_dropped"]
    sim._pending_presort = bool(scal.get("pending_presort", False))
    sim._pending_resume = bool(scal.get("pending_resume", False))
    sim.comm_stats = dict(scal.get("comm_stats", sim.comm_stats))
    sim._rebalance_armed = bool(scal.get("rebalance_armed", True))
    dev = sim.device
    t = lambda name, dtype: torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=dev)
    dtypes = {"alive": torch.bool, "slab_valid": torch.bool, "slots": torch.int32, "pslot": torch.int32}
    tree = {key: t(f"['state']/['{key}']", dtypes.get(key, torch.float32)) for key in sim.state if key != "fields"}
    tree["fields"] = [t(f"['state']/['fields']/[{i}]", torch.float32) for i in range(6)]
    sim.set_global_state(tree)
    pt = lambda name, dtype: torch.as_tensor(np.array(arrays[_leaf(("policy_state", name))]), dtype=dtype, device=dev)
    sim.policy_state = SortPolicyState(
        steps_since_sort=pt("steps_since_sort", torch.int32), rebuilds_since_sort=pt("rebuilds_since_sort", torch.int32),
        baseline_proxy=pt("baseline_proxy", torch.float32), proxy_ema=pt("proxy_ema", torch.float32))


def restore_simulation(sim, path: str) -> None:
    """Restore a checkpoint into a compatible driver: the same grid and
    particle count (and mesh); the capacity (and ``mig_cap``, ``n_local``)
    are the checkpoint's. The window's captured step is dropped (the next
    window captures anew)."""
    arrays, meta = _read_dir(path)
    distributed = _is_dist(sim)
    if meta["driver"] != ("dist" if distributed else "single"):
        raise ValueError(f"checkpoint was written by the {meta['driver']!r} driver")
    scal = meta["scalars"]
    if distributed:
        _restore_dist(sim, arrays, scal)
    else:
        _check_leaves(arrays, _flatten(sim.state, sim.policy_state))
        sim.config = dataclasses.replace(sim.config, capacity=scal["capacity"])
        sim.state, sim.policy_state = state_from_reference(_short_names(arrays), sim.config, sim.device)
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


def load_simulation(path: str, device=None, *, mesh=None):
    """Rebuild the driver a checkpoint describes from its embedded spec, on
    ``device`` (default ``cuda``, as `make_simulation`; over the ranks of
    ``mesh``, a `PicMesh`, on each rank's), and restore it."""
    from repro_torch.api.facade import make_simulation
    from repro_torch.api.spec import SimSpec

    meta = _read_meta(path)
    if meta.get("spec") is None:
        raise ValueError("checkpoint has no embedded SimSpec; build the driver yourself and call "
                         "restore_simulation(sim, path)")
    sim = make_simulation(SimSpec.from_dict(meta["spec"]), device=device, mesh=mesh)
    restore_simulation(sim, path)
    return sim


# -- ensemble members ------------------------------------------------------------


def tree_member_slice(tree, i: int):
    """Member ``i`` of a stacked tree (nested dataclasses of tensors): every
    tensor ``t`` as its view ``t[i]``, so a member's tensors are the
    bucket's; other leaves stay as they are."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: tree_member_slice(getattr(tree, f.name), i)
                                            for f in dataclasses.fields(tree)})
    return tree


def tree_member_set(tree, i: int, member) -> None:
    """Write ``member`` (no member axis) into slot ``i`` of a stacked tree,
    in place (``copy_``): the stacked tensors keep their addresses, so a
    CUDA graph captured over them stays valid. Shapes must match the slot
    exactly: re-bin a member saved at another capacity first
    (`restore_ensemble_member`). Leaves other than tensors are left
    alone."""
    if isinstance(tree, torch.Tensor):
        if tuple(tree.shape[1:]) != tuple(member.shape):
            raise ValueError(f"member leaf shape {tuple(member.shape)} does not fit stacked slot "
                             f"{tuple(tree.shape)}[{i}]")
        tree[i].copy_(member)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            tree_member_set(getattr(tree, f.name), i, getattr(member, f.name))


def save_ensemble_member(ens, i: int, path: str) -> None:
    """Checkpoint member ``i`` of an ensemble as a standard single-driver
    checkpoint: `load_simulation` (of either package) rebuilds it as a
    standalone `Simulation` when the member has a spec, and
    `restore_ensemble_member` installs it back into an ensemble slot."""
    spec = ens.specs[i]
    pairs = _flatten(ens.member_state(i), ens.member_policy_state(i))
    scalars = {
        "sorts": int(ens.sorts[i]),
        "rebuilds": int(ens.rebuilds[i]),
        "host_step": int(ens.host_step[i]),
        "capacity": ens.config.capacity,
        # an ensemble drives the device policy only: a standalone resume
        # starts its host-loop policy counters afresh
        "host_policy": {"steps_since_sort": 0, "rebuilds_since_sort": 0, "baseline_perf": None, "perf_ema": None},
        "history": ens.histories[i],
        "growths": dict(ens.growths),
        "halts": dict(ens.halts),
        "retries": 0,
        "restarts": 0,
        "discarded_steps": 0,
    }
    meta = {"driver": "single", "spec": None if spec is None else spec.to_dict(), "scalars": scalars}
    _write_dir(path, [n for n, _ in pairs], [_host(leaf) for _, leaf in pairs], meta)


def restore_ensemble_member(ens, i: int, path: str) -> None:
    """Install a single-driver checkpoint (of either package) into slot
    ``i`` of an ensemble, in place. A checkpoint at another bin capacity is
    re-binned at the ensemble's without a permutation (its particle order,
    and so its continuation, is kept); one too dense for the ensemble's
    capacity is refused. The grid and the particle count must match the
    slot."""
    arrays, meta = _read_dir(path)
    if meta["driver"] != "single":
        raise ValueError(f"ensemble member slots take 'single' driver checkpoints, got {meta['driver']!r}")
    scal = meta["scalars"]
    template = ens.member_state(i)
    pos = arrays.get(_leaf(("state", "particles", "pos")))
    if pos is not None and pos.shape != tuple(template.particles.pos.shape):
        raise ValueError(f"checkpoint carries {pos.shape[0]} particles but ensemble slot {i} holds "
                         f"{template.particles.pos.shape[0]}: the member belongs to a different bucket")
    _check_leaves(arrays, _flatten(template, ens.member_policy_state(i)))
    saved = dataclasses.replace(ens.config, capacity=int(scal["capacity"]))
    state, pstate = state_from_reference(_short_names(arrays), saved, ens.device)
    if saved.capacity != ens.config.capacity:
        state, overflow = ens._rebin(state)
        if int(overflow):
            raise ValueError(f"checkpointed member is denser than the ensemble capacity {ens.config.capacity} "
                             f"(saved capacity {saved.capacity}); grow the ensemble before restoring this member")
    ens.set_member(i, state, pstate)
    ens.host_step[i] = int(scal["host_step"])
    ens.sorts[i] = int(scal["sorts"])
    ens.rebuilds[i] = int(scal["rebuilds"])
    ens.histories[i] = list(scal["history"])
    ens._prewarm_dispatch()


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
        if _writes(self.sim):
            for old in self._steps()[: -self.keep]:
                shutil.rmtree(self._path(old), ignore_errors=True)
        return True


# -- the step-stamped tree store (the fit's and the LM trainer's checkpoints) ---------


def _flatten_with_names(tree, path=()) -> list[tuple[str, torch.Tensor]]:
    """(name, leaf) pairs of nested dicts, tuples and lists, dict keys sorted,
    each named as JAX's ``tree_flatten_with_path`` names it
    (``['opt']/['mu']/['laser.a0']``, ``['params']/['layers']/[0]/...``)."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _flatten_with_names(tree[k], path + (f"[{k!r}]",))]
    if isinstance(tree, (tuple, list)):
        return [pair for i, t in enumerate(tree) for pair in _flatten_with_names(t, path + (f"[{i}]",))]
    return [("/".join(path), tree)]


def _host_bits(leaf: torch.Tensor, *, own: bool) -> tuple[np.ndarray, str]:
    """A leaf on the host as numpy, and its dtype's name: a bfloat16 leaf as
    its 16-bit patterns (numpy has no bfloat16), named ``bfloat16``. With
    ``own`` a leaf already on the host is copied, so that later in-place
    updates of it do not reach the array."""
    t = leaf.detach()
    name = "bfloat16" if t.dtype == torch.bfloat16 else None
    if name:
        t = t.view(torch.int16)
    if t.device.type == "cpu" and own:
        t = t.clone()
    a = t.cpu().numpy()
    return a, name or str(a.dtype)


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array as a tensor on the host, bfloat16 patterns as
    bfloat16 (also the reference's `ml_dtypes` bfloat16, 2-byte items)."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    """Step-stamped checkpoints of a tree of tensors under ``directory``,
    the newest ``keep`` kept. Counterpart of
    `repro.checkpoint.CheckpointManager` (single process).

    ``save(..., blocking=False)`` copies every leaf to the host before it
    returns and writes the files on a background thread, which ``wait()``
    joins (and re-raises what it raised): a caller may update its tensors in
    place as soon as ``save`` returns. ``restore`` copies the stored leaves
    into the caller's tensors, so a full-width state is never held twice on
    the device. bfloat16 leaves are stored as their bit
    patterns, with ``bfloat16`` in the manifest, and restored bit for bit.

    Over ``ranks`` (a `distributed.ranks.AxisRanks` or `RankGrid` whose
    ranks hold the same state) rank 0 alone writes, sweeps and collects;
    the other ranks' ``save`` does nothing. ``latest_step`` is rank 0's on
    every rank (`agree`), and ``restore`` waits for rank 0's write, then
    for every rank (a barrier), before any rank reads. Both are
    collective: every rank calls them.

    Over a (data, model) layout (``ranks``, a `distributed.ranks.MeshRanks`)
    each rank holds its block of the model axis and its slice of the data
    axis: ``blocks`` (a `distributed.sharding.ModelBlocks` of the saved
    tree) gathers every leaf whole on ``save``, a bounded chunk at a time
    (collective over every rank of the layout; rank 0 copies each chunk to
    the host and writes the tree), and on ``restore`` every rank takes its
    own block of each whole leaf. A checkpoint so holds the whole tree, and
    moves between packages and layouts."""

    def __init__(self, directory: str, *, keep: int = 3, ranks=None, blocks=None):
        if blocks is not None and not hasattr(ranks, "model"):
            raise ValueError("a checkpoint of model-axis blocks needs the (data, model) layout they come from")
        self.directory = directory
        self.keep = keep
        self.ranks = ranks
        self.blocks = blocks
        self.writer = ranks is None or ranks.rank == 0
        if self.writer:
            os.makedirs(directory, exist_ok=True)
            clean_stale_tmp(directory)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree, *, blocking: bool = True) -> None:
        """Write ``tree`` as ``step_<step:09d>`` (atomically), point
        ``LATEST`` at it, and drop all but the newest ``keep``. With
        ``blocking=False`` the write runs on a background thread; the host
        copies are made before this returns. Over ranks only rank 0 writes;
        with ``blocks`` every rank gathers each leaf whole first."""
        pairs = _flatten_with_names(tree)
        leaves = [x for _, x in pairs] if self.blocks is None else self.blocks.whole_leaves(tree, keep=self.writer)
        if not self.writer:
            if self.blocks is not None:
                for _ in leaves:  # every rank takes part in each leaf's gathers
                    pass
            return
        names = [n for n, _ in pairs]
        host = [_host_bits(x, own=not blocking) for x in leaves]
        if blocking:
            self._write(step, names, host)
            return
        self.wait()
        self._thread = threading.Thread(target=self._write_logged, args=(step, names, host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background write, if any, and raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_logged(self, step: int, names, host) -> None:
        try:
            self._write(step, names, host)
        except Exception as exc:  # noqa: BLE001 — handed to wait(), which re-raises it
            self._error = exc

    def _write(self, step: int, names, host) -> None:
        arrays = [a for a, _ in host]
        final = os.path.join(self.directory, f"step_{step:09d}")
        tmp = final + f".tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **{f"a{i}": a for i, a in enumerate(arrays)})
        manifest = {
            "step": step,
            "names": names,
            "shapes": [list(a.shape) for a in arrays],
            "dtypes": [dt for _, dt in host],
            "checksums": array_checksums(arrays),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.directory, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.directory, "LATEST.tmp"), os.path.join(self.directory, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)

    def all_steps(self) -> list[int]:
        return sorted(int(name[5:]) for name in os.listdir(self.directory)
                      if name.startswith("step_") and ".tmp" not in name and ".old" not in name)

    def latest_step(self) -> int | None:
        """The newest step written (rank 0's, on every rank), or None."""
        if self.ranks is None:
            return self._latest_on_disk()
        mine = self._latest_on_disk() if self.writer else None
        step = self.ranks.agree(-1 if mine is None else mine)
        return None if step < 0 else step

    def _latest_on_disk(self) -> int | None:
        path = os.path.join(self.directory, "LATEST")
        if not os.path.exists(path):
            steps = self.all_steps()
            return steps[-1] if steps else None
        with open(path) as f:
            return int(f.read().strip())

    def restore(self, tree, step: int | None = None):
        """Copy checkpoint ``step`` (the latest by default) into the tensors
        of ``tree``, which keep their dtype and device. Returns ``(tree,
        step)``. Over ranks every rank reads once rank 0's write has
        landed."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        if self.ranks is not None:
            self.wait()
            self.ranks.barrier()
        d = os.path.join(self.directory, f"step_{step:09d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            with np.load(os.path.join(d, "arrays.npz")) as data:
                arrays = [np.asarray(data[f"a{i}"]) for i in range(len(manifest["names"]))]
        except Exception as exc:
            raise ValueError(f"corrupt or truncated checkpoint at {d}: {exc}") from exc
        if "checksums" in manifest:
            verify_checksums(arrays, manifest["checksums"], manifest["names"], d)
        pairs = _flatten_with_names(tree)
        if [n for n, _ in pairs] != manifest["names"]:
            raise ValueError(f"checkpoint/model structure mismatch at {d}")
        dtypes = manifest.get("dtypes", [str(a.dtype) for a in arrays])
        values = [_from_host(arr, dt) for arr, dt in zip(arrays, dtypes)]
        if self.blocks is not None:  # this rank's block of each whole leaf
            values = [self.blocks.block_of(i, v) for i, v in enumerate(values)]
        for v, (name, leaf) in zip(values, pairs):
            if tuple(v.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {name} has shape {tuple(v.shape)}, expected {tuple(leaf.shape)}")
        with torch.no_grad():
            for v, (_, leaf) in zip(values, pairs):
                leaf.copy_(v)
        return tree, step

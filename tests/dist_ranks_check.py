"""The port's distributed driver over ranks, one process a rank, on the CPU.

tests/test_torch_dist_ranks.py starts WORLD processes of

    PYTHONPATH=src python tests/dist_ranks_check.py RANK WORLD STORE OUT INPUTS

Each joins a gloo group through a ``FileStore`` in STORE and runs every
case below on the rank grids of `GRIDS`, each the x-first choice of its
rank count on its mesh (the two-rank grid on the subgroup of ranks 0 and
1); rank 0 writes each case's results, gathered over the whole mesh, into
OUT. The test runs the same functions with no
rank grid, the one-process stack, and holds the two bit for bit. INPUTS is
the numpy file `make_inputs` writes. No JAX here: the reference's run of
`ref_parity` is the test's own subprocess.

Cases:

- `primitives`: `ring_shift` (float32, bool, uint16, both axes, both
  directions), the halo extension and fold (serialized and overlapped),
  `migrate_axis` (plain and compressed, both axes) and the reductions;
- `windowed`: ``uniform`` 8^3 at order 3 on 4x2 (2x4), 20 steps in
  windows of 10, from a plasma held in the first x-shard (y-shard): the
  imbalance halt re-splits the mesh (4x2 -> 2x4, or 2x4 -> 4x2, the rank
  grid re-chosen with it), ``mig_cap`` 4 grows, an injected receive-side
  drop grows ``n_local``; checkpoints at steps 10 and 20, and a driver
  loaded from step 10's continued to 20;
- `ref_parity`: ``uniform`` 8^3 at order 1 on 2x2, 10 steps in windows of
  5, which the test also runs in the reference;
- `auto_choice` (the (2, 1) grid on 2x2): backend ``auto`` from the
  skewed plasma, whose ranks' own occupancies would pick different
  backends: rank 0 alone resolves, at the mesh's occupancy, and every rank
  keeps its choice;
- `chaos` (the (2, 2) grid, 2x4): the health sentinel on, a NaN injected into
  ``ez`` (rolled back to each rank's window-entry snapshot and retried),
  and a crash restored from the autosave rank 0 wrote;
- `dist_faces` (the (2, 2) grid, 2x4): the reference's functional faces
  on each rank's block, `make_dist_step` (3 steps), `make_dist_sort` and a
  `make_dist_window` window of 8 steps with ``n_target`` 5, from a hot
  plasma (particles cross shards from the second step on).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

#: rank grid -> (the mesh it splits, the ranks it takes: the first ones of
#: the group); each grid is the x-first choice of its ranks on its mesh
GRIDS = {"2x1": ((4, 2), 2), "4x1": ((4, 2), 4), "2x2": ((2, 4), 4)}
MESHES = ((4, 2), (2, 4))
#: the windowed run's plasma on each mesh: held in the first shard along
#: the mesh's longer axis, so that the re-split turns the mesh round
SKEWED = {(4, 2): "skewed", (2, 4): "skewed_y"}
WORLD = 4
G = 2                  # halo width of the primitives (order 3's guard)
LOCAL = (4, 4, 4)      # the primitives' local block: nx, ny >= 2g for the overlapped fold
N_PRIM = 48            # particle rows a shard in the primitives
MIG_CAP = 8
WINDOWED = dict(grid=(8, 8, 8), order=3, dt=0.2, capacity=16, steps=20, window=10, diagnostics_every=5, mesh="4x2",
                mig_cap=4, rebalance_enable=True, imbalance_ratio=2.0, fault={"kind": "recv_drop", "step": 3})
REF_PARITY = dict(grid=(8, 8, 8), order=1, dt=0.2, capacity=16, steps=10, window=5, diagnostics_every=5, mesh="2x2",
                  mig_cap=512)
POLICY = dict(sort_interval=5, sort_trigger_perf_enable=False)
CHAOS = dict(grid=(8, 8, 8), order=1, dt=0.2, capacity=16, steps=12, window=4, diagnostics_every=4, mesh="4x2",
             mig_cap=512, health={"enable": True})
CHAOS_FAULTS = {"nan_field": {"kind": "nan_field", "step": 5, "component": "ez"}, "crash": {"kind": "crash", "step": 6}}
STATE_KEYS = ("pos", "u", "w", "alive", "slots", "pslot", "slab_d", "slab_valid", "mid_pos", "mid_u")
FIELDS = ("ex", "ey", "ez", "bx", "by", "bz")


def lattice_plasma(grid, *, ppc=2, u_thermal=0.05, seed=0):
    """Lattice plasma, ``ppc`` a cell per dimension, numpy thermal momenta."""
    rng = np.random.default_rng(seed)
    off = (np.arange(ppc) + 0.5) / ppc
    cells = np.stack(np.meshgrid(*(np.arange(n) for n in grid), indexing="ij"), -1).reshape(-1, 1, 3)
    lattice = np.stack(np.meshgrid(off, off, off, indexing="ij"), -1).reshape(1, -1, 3)
    pos = (cells + lattice).reshape(-1, 3).astype(np.float32)
    u = (u_thermal * rng.normal(size=(pos.shape[0], 3))).astype(np.float32)
    w = np.full(pos.shape[0], 1.0 / ppc**3, np.float32)
    return dict(pos=pos, u=u, w=w, alive=w > 0)


def make_inputs(path: str) -> None:
    """Every case's inputs, made from seeds, into one numpy file (the
    primitives' stacks ``[4, 2, ...]``, reshaped to a 2x4 mesh's)."""
    rng = np.random.default_rng(7)
    sx, sy = MESHES[0]
    nx, ny, nz = LOCAL
    out = {
        "prim.f32": rng.normal(size=(sx, sy, 5, 3)).astype(np.float32),
        "prim.bool": rng.random((sx, sy, 5)) < 0.5,
        "prim.u16": rng.integers(0, 65536, size=(sx, sy, 7), dtype=np.uint16),
        "prim.field": rng.normal(size=(sx, sy, 6, nx, ny, nz)).astype(np.float32),
        "prim.padded": rng.normal(size=(sx, sy, 3, nx + 2 * G, ny + 2 * G, nz)).astype(np.float32),
        "prim.vals": rng.normal(size=(sx, sy)).astype(np.float32),
        "prim.counts": rng.integers(0, 1000, size=(sx, sy)),
        # particles a hair inside and outside the block, some dead
        "prim.pos": rng.uniform(-1.0, nx + 1.0, size=(sx, sy, N_PRIM, 3)).astype(np.float32),
        "prim.u": rng.normal(size=(sx, sy, N_PRIM, 3)).astype(np.float32),
        "prim.w": rng.uniform(0.5, 1.5, size=(sx, sy, N_PRIM)).astype(np.float32),
        "prim.alive": rng.random((sx, sy, N_PRIM)) < 0.8,
    }
    skewed = lattice_plasma((8, 8, 8), u_thermal=0.3, seed=1)
    skewed["alive"] &= skewed["pos"][:, 0] < 2.0  # the first x-shard of 4x2 only
    out.update({f"skewed.{k}": v for k, v in skewed.items()})
    skewed_y = lattice_plasma((8, 8, 8), u_thermal=0.3, seed=4)
    skewed_y["alive"] &= skewed_y["pos"][:, 1] < 2.0  # the first y-shard of 2x4 only
    out.update({f"skewed_y.{k}": v for k, v in skewed_y.items()})
    out.update({f"uniform.{k}": v for k, v in lattice_plasma((8, 8, 8), u_thermal=0.05, seed=2).items()})
    out.update({f"hot.{k}": v for k, v in lattice_plasma((8, 8, 8), u_thermal=0.5, seed=3).items()})
    np.savez(path, **out)


def _particles(inp: dict, name: str):
    from repro_torch.pic import ParticleState

    return ParticleState(**{k: torch.from_numpy(inp[f"{name}.{k}"].copy()) for k in ("pos", "u", "w", "alive")})


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy on the host (a CPU tensor's ``numpy()`` would share its
    memory, which a donating window overwrites)."""
    return t.detach().cpu().numpy().copy()


# -- the cases ------------------------------------------------------------------------------


def primitives(inp: dict, ranks, mesh) -> dict:
    """The exchanges and reductions on the inputs' stacks, reshaped to
    ``mesh``: this rank's block in, the whole mesh's results out."""
    from repro_torch.pic import distributed as pd

    whole = lambda a: torch.from_numpy(a.reshape(tuple(mesh) + a.shape[2:]).copy())
    block = whole if ranks is None else (lambda a: ranks.block(whole(a)).contiguous())
    full = (lambda t: t) if ranks is None else ranks.gather
    out = {}
    for name in ("f32", "bool", "u16"):
        t = block(inp[f"prim.{name}"])
        for axis in (0, 1):
            for shift in (1, -1):
                out[f"ring.{name}.{axis}.{shift}"] = full(pd.ring_shift(t, axis, shift, ranks))
    f, zf = block(inp["prim.field"]), block(inp["prim.padded"])
    out["halo.extend"] = full(pd.halo_extend(pd.halo_extend(f, G, 0, 0, ranks), G, 1, 1, ranks))
    out["halo.extend_overlapped"] = full(pd.halo_extend_overlapped(f, G, ranks))
    out["halo.reduce"] = full(pd.halo_reduce(pd.halo_reduce(zf, G, 1, 1, ranks), G, 0, 0, ranks))
    out["halo.reduce_overlapped"] = full(pd.halo_reduce_overlapped(zf, G, ranks))
    parts = [block(inp[f"prim.{k}"]) for k in ("pos", "u", "w", "alive")]
    for compress in (False, True):
        for coord in (0, 1):
            res = pd.migrate_axis(*parts, coord=coord, extent=LOCAL[coord], shard_axis=coord, mig_cap=MIG_CAP,
                                  local_shape=LOCAL, compress=compress, ranks=ranks)
            for k, t in zip(("pos", "u", "w", "alive", "send_overflow", "recv_dropped", "arrived"), res):
                out[f"migrate.{int(compress)}.{coord}.{k}"] = full(t)
    vals, counts = block(inp["prim.vals"]), block(inp["prim.counts"])
    out["psum.f32"], out["pmax.f32"] = pd.psum_all(vals, ranks), pd.pmax_all(vals, ranks)
    out["psum.int"], out["pmax.int"] = pd.psum_all(counts, ranks), pd.pmax_all(counts, ranks)
    return {k: _host(v) for k, v in out.items()}


def _summary(sim, prefix: str) -> tuple[dict, dict]:
    """A driver's whole-mesh state (a collective over ranks) and its host
    counters."""
    st = sim.global_state()
    arrays = {f"{prefix}{k}": _host(st[k]) for k in STATE_KEYS}
    arrays.update({f"{prefix}fields.{n}": _host(f) for n, f in zip(FIELDS, st["fields"])})
    arrays.update({f"{prefix}policy.{f.name}": _host(getattr(sim.policy_state, f.name))
                   for f in dataclasses.fields(sim.policy_state)})
    scalars = {"sorts": sim.sorts, "rebuilds": sim.rebuilds, "growths": dict(sim.growths), "halts": dict(sim.halts),
               "comm_stats": dict(sim.comm_stats), "capacity": sim.config.capacity, "mig_cap": sim.config.mig_cap,
               "n_local": sim.n_local, "host_step": sim._host_step, "history": sim.history,
               "mesh": list(sim.mesh_shape), "discarded_steps": sim.discarded_steps, "host_reads": sim.host_reads,
               "windows": sim.windows, "diagnostics": sim.diagnostics()}
    return arrays, {prefix: scalars}


def windowed(inp: dict, group, ckpt_dir: str, mesh) -> tuple[dict, dict]:
    """The 20-step run on ``mesh`` with its growths and re-split, its
    checkpoints, and a driver loaded from step 10's checkpoint run to step
    20. ``group`` None is the one-process stack."""
    import repro_torch.api as tapi
    from repro_torch.core import SortPolicyConfig
    from repro_torch.pic.distributed import make_pic_mesh

    spec = tapi.scenario("uniform", backend="torch", policy=SortPolicyConfig(**POLICY),
                         **dict(WINDOWED, mesh="{}x{}".format(*mesh)))
    plasma = _particles(inp, SKEWED[tuple(mesh)])
    mesh = None if group is None else make_pic_mesh(*mesh, group)
    sim = tapi.make_simulation(spec, particles=plasma, device="cpu", mesh=mesh)
    sim.run(10)
    sim.save(os.path.join(ckpt_dir, "step10"))
    sim.run(10)
    sim.save(os.path.join(ckpt_dir, "step20"))
    arrays, scalars = _summary(sim, "run.")
    with open(os.path.join(ckpt_dir, "step10", "checkpoint.json")) as f:
        saved_mesh = json.load(f)["scalars"]["mesh_shape"]
    mesh = None if group is None else make_pic_mesh(*saved_mesh, group)
    again = tapi.load_simulation(os.path.join(ckpt_dir, "step10"), device="cpu", mesh=mesh)
    again.run(10)
    more_arrays, more_scalars = _summary(again, "restored.")
    return {**arrays, **more_arrays}, {**scalars, **more_scalars}


def ref_parity(inp: dict, group) -> tuple[dict, dict]:
    """The run the test also makes in the reference: 2x2 at order 1."""
    import repro_torch.api as tapi
    from repro_torch.core import SortPolicyConfig
    from repro_torch.pic.distributed import make_pic_mesh

    spec = tapi.scenario("uniform", backend="torch", policy=SortPolicyConfig(sort_interval=20,
                                                                             sort_trigger_perf_enable=False),
                         **REF_PARITY)
    mesh = None if group is None else make_pic_mesh(2, 2, group)
    sim = tapi.make_simulation(spec, particles=_particles(inp, "uniform"), device="cpu", mesh=mesh)
    sim.run()
    return _summary(sim, "")


def chaos(inp: dict, group, autosave_dir: str, mesh) -> tuple[dict, dict]:
    """A rolled-back NaN and a crash restored from its autosave, on
    ``mesh``."""
    import repro_torch.api as tapi
    from repro_torch.core import SortPolicyConfig
    from repro_torch.pic.distributed import make_pic_mesh

    arrays, scalars = {}, {}
    for name, fault in CHAOS_FAULTS.items():
        spec = tapi.scenario("uniform", backend="torch", policy=SortPolicyConfig(**POLICY), fault=fault,
                             **dict(CHAOS, mesh="{}x{}".format(*mesh)))
        pm = None if group is None else make_pic_mesh(*mesh, group)
        sim = tapi.make_simulation(spec, particles=_particles(inp, "uniform"), device="cpu", mesh=pm)
        autosave = dict(autosave_every=4, autosave_path=os.path.join(autosave_dir, name)) if name == "crash" else {}
        sim.run(**autosave)
        a, s = _summary(sim, f"{name}.")
        s[f"{name}."].update(retries=sim.retries, restarts=sim.restarts)
        arrays.update(a)
        scalars.update(s)
    return arrays, scalars


def dist_faces(inp: dict, group, mesh) -> dict:
    """The functional faces on ``mesh`` from a driver's state (this rank's
    block over ranks), their results gathered over the mesh."""
    import repro_torch.api as tapi
    from repro_torch.core import SortPolicyConfig
    from repro_torch.pic.dist_simulation import make_dist_window
    from repro_torch.pic.distributed import (
        blocks_from_global,
        gather_shards,
        global_from_blocks,
        make_dist_sort,
        make_dist_step,
        make_pic_mesh,
    )

    spec = tapi.scenario("uniform", backend="torch", policy=SortPolicyConfig(sort_interval=3, min_sort_interval=2,
                                                                             sort_trigger_perf_enable=False),
                         **dict(REF_PARITY, mesh="{}x{}".format(*mesh), capacity=32))
    mesh = mesh if group is None else make_pic_mesh(*mesh, group)
    sim = tapi.make_simulation(spec, particles=_particles(inp, "hot"), device="cpu",
                               mesh=None if group is None else mesh)
    ranks = sim.ranks
    bx, by = sim.shard_state.pos.shape[:2]
    full = lambda t: _host(gather_shards(t, ranks))
    grid = lambda fields: {f"fields.{n}": _host(f) for n, f in
                           zip(FIELDS, global_from_blocks(blocks_from_global(fields, bx, by), ranks).unbind(0))}
    st = sim.state
    keys = ("pos", "u", "w", "alive", "slots", "pslot", "slab_d", "slab_valid")
    step = make_dist_step(mesh, sim.config)
    cur = (st["fields"], *(st[k] for k in keys))
    out = {}
    for i in range(3):
        *cur, stats = step(*cur)
        out.update({f"step{i}.{k}": _host(v) for k, v in stats.items()})
    out.update({f"step.{k}": full(v) for k, v in zip(keys, cur[1:])})
    out.update({f"step.{k}": v for k, v in grid(cur[0]).items()})
    sorted_ = make_dist_sort(mesh, sim.config)(*cur[1:5])
    out.update({f"sort.{k}": full(v) for k, v in zip(keys, sorted_[:8])})
    out["sort.overflow"] = _host(sorted_[8])
    win = make_dist_window(mesh, sim.config, sim.policy, 8)
    res = win(*cur, st["mid_pos"].clone(), st["mid_u"].clone(), dataclasses.replace(sim.policy_state), 5, 0, 0, 3, 1,
              None)
    out.update({f"window.{k}": full(v) for k, v in zip(keys + ("mid_pos", "mid_u"), res[1:11])})
    out.update({f"window.{k}": v for k, v in grid(res[0]).items()})
    bundle = res[-1]
    out.update({f"bundle.{k}": _host(v) for k, v in bundle.items() if k != "per_step"})
    out.update({f"bundle.per_step.{k}": _host(v) for k, v in bundle["per_step"].items()})
    return out


def auto_choice(inp: dict, group) -> dict:
    """Backend ``auto`` on 2x2 from the skewed plasma, every particle on
    rank 0's block. The dispatcher's timing is replaced by a choice that
    turns on the occupancy it is given (as a timing may): each rank's own
    occupancy would pick another backend, the mesh's picks ``cuda``. Every
    rank's count of resolutions and the occupancy each resolved at, each
    rank's own occupancy, and the backends each rank then holds."""
    import repro_torch.api as tapi
    from repro_torch.kernels import dispatch
    from repro_torch.pic.distributed import make_pic_mesh

    parts = _particles(inp, "skewed")
    spec = tapi.scenario("uniform", backend="auto", **REF_PARITY)
    n_cells = 4 * 4 * 8
    mesh_fill = -(-int(parts.alive.sum()) // (4 * n_cells))
    seen = []

    def choose(ops, *, fill, **key):
        seen.append(fill)
        return {op: "cuda" if fill <= mesh_fill else "torch" for op in ops}

    real = dispatch.prewarm
    dispatch.prewarm = choose
    try:
        sim = tapi.make_simulation(spec, particles=parts, device="cpu", mesh=make_pic_mesh(2, 2, group))
    finally:
        dispatch.prewarm = real
    c, ranks = sim.config, sim.ranks
    names = sorted(dispatch.BACKEND_PRIORITY)
    held = [names.index(dispatch.resolve(op, "auto", device="cpu", order=c.order, grid_shape=c.local_grid.shape,
                                         capacity=c.capacity, dtype=torch.float32))
            for op in dispatch.ops_for_modes(c.deposition, c.gather)]
    dispatch.clear_memo()
    own = -(-int(torch.count_nonzero(sim.shard_state.alive)) // (2 * n_cells))
    every = lambda v: [int(x) for x in ranks.values(torch.tensor(v, dtype=torch.int64))]
    return {"mesh_fill": mesh_fill, "resolutions": every(len(seen)), "fill": every(seen[0] if seen else -1),
            "own_fill": every(own), "held": [[names[i] for i in every(h)] for h in held]}


# -- one rank -------------------------------------------------------------------------------


def _write(out_dir: str, name: str, arrays: dict, scalars: dict | None = None) -> None:
    np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)
    if scalars is not None:
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(scalars, f)


def main(rank: int, world: int, store: str, out_dir: str, inputs: str) -> None:
    import torch.distributed as dist

    from repro_torch.distributed.ranks import close_ranks, init_ranks
    from repro_torch.pic.distributed import make_pic_mesh

    torch.set_num_threads(1)
    init_ranks(rank, world, store, device="cpu", timeout_s=120.0)
    inp = dict(np.load(inputs))
    pair = dist.new_group([0, 1])  # every rank makes every group, members or not
    for name, (mesh, n) in GRIDS.items():
        if rank >= n:
            continue
        group = pair if n == 2 else dist.group.WORLD
        ranks = make_pic_mesh(*mesh, group).ranks
        if f"{ranks.px}x{ranks.py}" != name:
            raise AssertionError(f"{n} ranks on {mesh} chose the grid {ranks}, not {name}")
        prim = primitives(inp, ranks, mesh)
        run_arrays, run_scalars = windowed(inp, group, os.path.join(out_dir, f"ckpt.{name}"), mesh)
        if rank == 0:
            _write(out_dir, f"{name}.primitives", prim)
            _write(out_dir, f"{name}.windowed", run_arrays, run_scalars)
        if n == 2:
            arrays, scalars = ref_parity(inp, group)
            chosen = auto_choice(inp, group)
            if rank == 0:
                _write(out_dir, f"{name}.ref_parity", arrays, scalars)
                _write(out_dir, f"{name}.auto_choice", {}, chosen)
        if name == "2x2":
            arrays, scalars = chaos(inp, group, os.path.join(out_dir, f"auto.{name}"), mesh)
            built = dist_faces(inp, group, mesh)
            if rank == 0:
                _write(out_dir, f"{name}.chaos", arrays, scalars)
                _write(out_dir, f"{name}.dist_faces", built)
    close_ranks()
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])

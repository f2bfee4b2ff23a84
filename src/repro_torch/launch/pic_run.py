"""PIC simulation launcher of the port (counterpart of `repro.launch.pic_run`).

    PYTHONPATH=src python -m repro_torch.launch.pic_run --scenario uniform --steps 50
    PYTHONPATH=src python -m repro_torch.launch.pic_run --scenario lwfa --order 2
    PYTHONPATH=src python -m repro_torch.launch.pic_run --scenario uniform --device cpu --grid 8 8 8
    PYTHONPATH=src python -m repro_torch.launch.pic_run --deposition matrix_unfused --gather matrix_unfused
    PYTHONPATH=src python -m repro_torch.launch.pic_run --sort global
    PYTHONPATH=src python -m repro_torch.launch.pic_run --window 0
    PYTHONPATH=src python -m repro_torch.launch.pic_run --scenario lwfa --dump-spec lwfa.json
    PYTHONPATH=src python -m repro_torch.launch.pic_run --spec lwfa.json --steps 20
    PYTHONPATH=src python -m repro_torch.launch.pic_run --sentinel --fault nan_field:20:ez
    PYTHONPATH=src python -m repro_torch.launch.pic_run --sentinel --fault crash:20 --autosave-every 8
    PYTHONPATH=src python -m repro_torch.launch.pic_run --scenario two_stream --sweep drift=0.1,0.2,0.3 --ensemble 4
    PYTHONPATH=src python -m repro_torch.launch.pic_run --mesh 4x2 --grid 128 128 128 --order 3
    PYTHONPATH=src python -m repro_torch.launch.pic_run --mesh 4x2 --grid 128 128 128 --order 3 --ranks 4
    PYTHONPATH=src python -m repro_torch.launch.pic_run --ranks 2 --device cpu --mesh 2x2 --grid 8 8 8

Runs on the CUDA device unless ``--device`` names another. One warm-up
window (kernel build, the step's CUDA graph capture) runs first, then the
timed run; the launcher prints particle-steps/s, the sort counters, the
host reads and the energies. ``--deposition``, ``--gather`` and ``--sort``
pick the comparison modes of the reference; ``--window 0`` runs the
host-driven per-step loop (two warm-up steps; the timed line then gives host
reads per step). ``--sentinel`` turns on the health sentinel and its
rollback-and-retry supervisor, ``--fault`` injects a fault (``nan_field``,
``nan_momentum``, ``charge_scale``) at a step counter or crashes the host
there (``crash``), ``--autosave-every`` keeps rolling checkpoints (under
``--autosave-path``, default ``checkpoints/<scenario>``) that a crash
restores; the timed line then gives the halts, retries and restarts. ``--spec`` runs a SimSpec JSON file, written by this
launcher's ``--dump-spec`` or by the reference's, with the other options as
overrides; ``--dump-spec`` writes the resolved spec and exits. The
reference's deprecated flags are taken as it takes them: ``--workload``
is ``--scenario`` with a note, ``--use-pallas`` is ``--backend pallas``.
``--mesh SXxSY`` runs the distributed driver (`DistSimulation`), its
SX x SY shards on the one device (a ``--spec`` file's mesh is honoured the
same way); the lines then name the mesh and give the growths and the
communication totals (``comm_stats``: migrated particles, migration
payload bytes, the largest shard imbalance). ``--overlap-halo``,
``--compress-migration``, ``--rebalance`` and ``--imbalance-ratio`` set the
spec's communication options, as the reference's flags do. ``--ranks N``
spreads the mesh over N processes, one a rank (`torch.multiprocessing`,
a ``FileStore`` in a temporary directory): each holds its block of the
shards on its own card (NCCL), or on the CPU with ``--device cpu``
(gloo); rank 0 prints the lines. More ranks than visible cards, or a rank
count whose grid does not divide the mesh, raises before any process
starts; a group that cannot form raises too, and nothing runs fewer
ranks in its place.
``--ensemble N`` runs N seed-staggered replicas of the spec as one batched
ensemble, ``--sweep PARAM=V1,V2,...`` (repeatable) a cartesian sweep over
flat overrides, N replicas a point (`repro_torch.api.EnsembleSpec`): the
members are grouped into shape buckets, each advanced with one host read a
window, and the summary gives ms per member-step, host reads, captures and
growths (``--dump-spec`` then writes the EnsembleSpec). ``--profile``
then runs two more
windows under `torch.profiler` and prints where the time went: first one
window as it runs, replays of the captured step; then one window run
eagerly, which reads the step's decisions on the host, because the
``pic.*`` ranges of `repro_torch.pic.simulation` are recorded only when the
step's Python runs: device time per step phase, the top kernels, the
port's own kernels (ms per step and per launch), and the device's busy and
idle share of each window's wall time.
"""

from __future__ import annotations

import argparse
import functools
import os
import time
from collections import defaultdict

import torch

from repro_torch.api import (
    EnsembleSpec,
    MeshSpec,
    SimSpec,
    apply_overrides,
    make_ensemble,
    make_simulation,
    scenario,
    scenario_names,
)


#: the kernels of `csrc`, as the profiler names them
PORT_KERNELS = ("fused_deposit_kernel", "fused_deposit_reduced_kernel", "fused_gather_kernel",
                "bin_outer_product_kernel", "bin_gather_kernel", "segment_accumulate_kernel")


def parse_fault(text: str) -> dict:
    """``KIND:STEP[:COMPONENT[:COUNT]]`` -> a FaultSpec dict, e.g.
    ``nan_field:40:ez``, ``crash:100`` or ``nan_momentum:10::0`` (count 0:
    every time)."""
    parts = text.split(":")
    if len(parts) < 2:
        raise ValueError(f"--fault wants KIND:STEP[:COMPONENT[:COUNT]], got {text!r}")
    out = {"kind": parts[0], "step": int(parts[1])}
    if len(parts) > 2 and parts[2]:
        out["component"] = parts[2]
    if len(parts) > 3 and parts[3]:
        out["count"] = int(parts[3])
    return out


def _sweep_value(text: str):
    """A sweep value: an int, else a float, else the text."""
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def parse_sweeps(texts) -> dict:
    """Repeated ``--sweep PARAM=V1,V2,...`` -> `EnsembleSpec.sweep` axes;
    PARAM must be a flat override of the registry."""
    from repro_torch.api.registry import _OVERRIDE_PATHS

    axes: dict[str, list] = {}
    for text in texts:
        name, sep, values = text.partition("=")
        if not sep or not values:
            raise ValueError(f"--sweep wants PARAM=V1,V2,..., got {text!r}")
        if name not in _OVERRIDE_PATHS:
            raise ValueError(f"--sweep {name}: not a flat override (one of {sorted(_OVERRIDE_PATHS)})")
        if name in axes:
            raise ValueError(f"--sweep {name}: axis given twice")
        axes[name] = [_sweep_value(v) for v in values.split(",")]
    return axes


def run_ensemble(ensemble: EnsembleSpec, device=None) -> None:
    """Build the ensemble's buckets, run them, print the summary and each
    member's diagnostics. The time includes each bucket's one-time window
    set-up (a warm-up step and the capture)."""
    t0 = time.perf_counter()
    ens = make_ensemble(ensemble, device=device)
    build_s = time.perf_counter() - t0
    dev = ens.sims[0].device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{ensemble.base.name}: ensemble of {ens.n_members} members in {len(ens.sims)} shape bucket(s) "
          f"({[s.n_members for s in ens.sims]} members/bucket), built in {build_s:.2f} s, device {dev} ({name})")
    t0 = time.perf_counter()
    ens.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t0
    member_steps = sum(int(s.host_step.sum()) for s in ens.sims)
    setup_s = sum(s.graph_setup_seconds for s in ens.sims)
    print(f"{member_steps} member-steps in {run_s:.3f} s: {1e3 * run_s / member_steps:.3f} ms/member-step "
          f"({1e3 * (run_s - setup_s) / member_steps:.3f} without the {setup_s:.3f} s of window set-up); host reads "
          f"{sum(s.host_reads for s in ens.sims)} in {sum(s.windows for s in ens.sims)} windows, captures "
          f"{sum(s.graph_captures for s in ens.sims)}, growths {sum(s.growths['capacity'] for s in ens.sims)}")
    for i, d in enumerate(ens.diagnostics()):
        print(f"  member {i} ({ens.members[i].name}): step {d['step']}, field={d['field_energy']:.4e} "
              f"kinetic={d['kinetic_energy']:.4e} total={d['total_energy']:.4e}, n_alive={d['n_alive']}")


def build_spec(args):
    overrides = {}
    for name in ("steps", "window", "order", "ppc", "backend", "deposition", "gather", "sort", "autosave_every",
                 "autosave_path"):
        value = getattr(args, name)
        if value is not None:
            overrides[name] = value
    if args.grid is not None:
        overrides["grid"] = tuple(args.grid)
    if args.use_pallas:
        overrides["use_pallas"] = True
    if args.sentinel:
        overrides["health"] = {"enable": True}
    if args.fault is not None:
        overrides["fault"] = parse_fault(args.fault)
    if args.mesh is not None:
        overrides["mesh"] = MeshSpec(args.mesh).shape
    comm = {}
    if args.overlap_halo:
        comm["overlap_halo"] = True
    if args.compress_migration:
        comm["compress_migration"] = True
    if args.rebalance:
        comm["rebalance_enable"] = True
    if args.imbalance_ratio is not None:
        comm["imbalance_ratio"] = args.imbalance_ratio
    if comm:
        overrides["comm"] = comm
    if args.spec is not None:
        with open(args.spec) as f:
            return apply_overrides(SimSpec.from_json(f.read()), **overrides)
    return scenario(args.scenario or args.workload or "uniform", **overrides)


def profile_window(sim, window: int, *, graphs: bool) -> None:
    """Run one window of a simulation on a CUDA device under the profiler
    and print its breakdown: as replays of the captured step (``graphs``),
    or eagerly. A range's device time is the profiler's device-side span of
    it (first kernel start to last kernel end); its host time includes any
    wait on a device read. The busy share sums kernel, copy and fill times,
    not the spans."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = sim.device
    steps0 = sim._host_step
    use_graphs, sim.use_graphs = sim.use_graphs, graphs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reads0 = sim.host_reads
        t0 = time.perf_counter()
        sim.run(window, window=window)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
        reads = sim.host_reads - reads0
    sim.use_graphs = use_graphs
    steps = max(sim._host_step - steps0, 1)
    print(f"profile, {'replays of the captured step' if graphs else 'eager window (its phase ranges exist only here)'}: "
          f"{reads} host reads")
    busy_us = 0.0
    by_kernel: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("pic."):  # not a range's span
            busy_us += e.time_range.elapsed_us()
            by_kernel[e.name][0] += 1
            by_kernel[e.name][1] += e.time_range.elapsed_us()
    # each range is listed twice, host side and device side: keep the larger of each time
    ranges: dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])
    for e in prof.key_averages():
        if e.key.startswith("pic."):
            r = ranges[e.key]
            r[:] = [max(r[0], e.count), max(r[1], e.device_time_total), max(r[2], e.cpu_time_total)]
    launches = sum(calls for calls, _ in by_kernel.values())
    print(f"profile: {steps} steps, wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / wall_us:.1%}; idle share {1 - busy_us / wall_us:.1%}), "
          f"{launches / steps:.0f} device operations/step")
    print(f"  {'range':<18}{'calls':>7}{'device ms/step':>16}{'host ms/step':>14}")
    for key, (calls, dev_us, host_us) in sorted(ranges.items()):
        print(f"  {key:<18}{calls:>7}{dev_us / 1e3 / steps:>16.3f}{host_us / 1e3 / steps:>14.3f}")
    print(f"  {'kernel':<60}{'calls':>7}{'ms/step':>10}")
    for name, (calls, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {name[:60]:<60}{calls:>7}{us / 1e3 / steps:>10.3f}")
    # the port's own kernels, each template instance summed in
    print(f"  {'port kernel':<32}{'calls':>7}{'ms/step':>10}{'ms/launch':>11}")
    for kernel in PORT_KERNELS:
        hits = [v for name, v in by_kernel.items() if f"::{kernel}" in name]
        calls, us = sum(c for c, _ in hits), sum(u for _, u in hits)
        if calls:
            print(f"  {kernel:<32}{calls:>7}{us / 1e3 / steps:>10.3f}{us / 1e3 / calls:>11.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", default=None, choices=scenario_names(), help="registered scenario (default uniform)")
    ap.add_argument("--workload", default=None, choices=["uniform", "lwfa"], help="deprecated alias of --scenario")
    ap.add_argument("--spec", default=None, metavar="FILE.json",
                    help="run a serialized SimSpec (from either package) instead of a named scenario")
    ap.add_argument("--dump-spec", default=None, metavar="PATH", help="write the resolved SimSpec JSON to PATH and exit")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--window", type=int, default=None,
                    help="steps per window (one bundle read per window); 0 = the host-driven per-step loop")
    ap.add_argument("--order", type=int, default=None, choices=[1, 2, 3])
    ap.add_argument("--grid", type=int, nargs=3, default=None)
    ap.add_argument("--ppc", type=int, default=None, help="particles per cell per dim")
    ap.add_argument("--backend", default=None,
                    choices=["auto", "torch", "cuda", "cuda_reduced", "xla", "pallas", "pallas_reduced"],
                    help="kernel backend of the bin contractions (reference names map onto the port's)")
    ap.add_argument("--use-pallas", action="store_true", help="deprecated: same as --backend pallas")
    ap.add_argument("--deposition", default=None, choices=["matrix", "matrix_unfused", "scatter", "rhocell"],
                    help="deposition mode (default: the scenario's, the fused matrix deposition)")
    ap.add_argument("--gather", default=None, choices=["matrix", "matrix_unfused", "scatter"],
                    help="field-gather mode (default: paired with the deposition, the fused matrix gather "
                         "beside a matrix deposition, the scatter gather beside the others)")
    ap.add_argument("--sort", default=None, choices=["incremental", "rebuild", "global", "none"],
                    help="sort mode: incremental GPMA + adaptive policy (default), bins rebuilt every step, a "
                         "global sort every step, or none (for the scatter paths)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--mesh", default=None, metavar="SXxSY",
                    help="run the distributed driver on an SXxSY shard mesh (every shard on the one device, or "
                         "spread over --ranks processes)")
    ap.add_argument("--ranks", type=int, default=None, metavar="N",
                    help="spread the mesh over N processes, one a rank, each on its own card (NCCL), or on the "
                         "CPU with --device cpu (gloo); rank 0 prints")
    ap.add_argument("--profile", action="store_true",
                    help="profile two more windows, captured and eager, and print their breakdowns")
    ft = ap.add_argument_group("fault tolerance")
    ft.add_argument("--sentinel", action="store_true",
                    help="the health sentinel (NaN/Inf, charge and energy checks in the window step) and the "
                         "rollback-and-retry supervisor")
    ft.add_argument("--autosave-every", type=int, default=None, metavar="N",
                    help="checkpoint every N steps (and at the run's start and end); an exception restores the "
                         "latest checkpoint and resumes")
    ft.add_argument("--autosave-path", default=None, metavar="DIR",
                    help="autosave directory (default: checkpoints/<scenario>)")
    ft.add_argument("--fault", default=None, metavar="KIND:STEP[:COMP[:COUNT]]",
                    help="inject a deterministic fault: nan_field:20:ez, nan_momentum:20, charge_scale:20, crash:20")
    cm = ap.add_argument_group("distributed communication")
    cm.add_argument("--overlap-halo", action="store_true",
                    help="slice every first-hop halo slab from the raw block, so no exchange waits on another "
                         "(bit-equal to the serialized exchange)")
    cm.add_argument("--compress-migration", action="store_true",
                    help="migrate uint16 fixed-point positions and bfloat16 momenta (weights exact)")
    cm.add_argument("--rebalance", action="store_true",
                    help="halt the window when the densest shard holds more than --imbalance-ratio times the mean, "
                         "and re-split the mesh")
    cm.add_argument("--imbalance-ratio", type=float, default=None, metavar="R",
                    help="the rebalance trigger's ratio (default 4.0)")
    en = ap.add_argument_group("ensembles")
    en.add_argument("--ensemble", type=int, default=None, metavar="N",
                    help="run N seed-staggered replicas of the spec as one batched ensemble (with --sweep: N "
                         "replicas a sweep point)")
    en.add_argument("--sweep", action="append", default=None, metavar="PARAM=V1,V2,...",
                    help="repeatable: one cartesian sweep axis over a flat override (e.g. --sweep drift=0.1,0.2 "
                         "--sweep order=1,2); members of one compiled shape share a bucket")
    args = ap.parse_args(argv)
    if (args.scenario or args.workload) and args.spec:
        ap.error("--scenario/--workload and --spec are mutually exclusive")
    if args.workload:
        print("note: --workload is deprecated, use --scenario (scenario defaults were unified: 'lwfa' now runs the "
              "canonical registry parameters, not the old launcher variant)")
    try:
        spec = build_spec(args)
        ensemble = None
        if args.sweep:
            ensemble = EnsembleSpec.sweep(spec, parse_sweeps(args.sweep), replicas=args.ensemble or 1)
        elif args.ensemble is not None:
            ensemble = EnsembleSpec.replicate(spec, args.ensemble)
        if ensemble is not None:
            ensemble.members()  # an override that does not apply fails here, in one line
    except (OSError, ValueError, TypeError, KeyError, NotImplementedError) as e:
        ap.error(str(e))
    if args.dump_spec:
        with open(args.dump_spec, "w") as f:
            f.write(spec.to_json() if ensemble is None else ensemble.to_json())
        print(f"wrote {args.dump_spec}")
        return
    # float32 products stay float32 (cuDNN would otherwise default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if ensemble is not None:
        if args.profile:
            ap.error("--profile profiles one simulation; it does not run ensembles")
        if args.ranks is not None:
            ap.error("--ranks spreads one mesh over processes; it does not run ensembles")
        run_ensemble(ensemble, device=args.device)
        return
    if args.ranks is not None:
        if spec.mesh.shape is None:
            ap.error("--ranks spreads a mesh over processes: name one with --mesh SXxSY")
        if args.profile:
            ap.error("--profile profiles one process; it does not run --ranks")
        run_ranks(spec, args.ranks, device=args.device)
        return

    sim = make_simulation(spec, device=args.device)
    if args.profile and sim.device.type != "cuda":
        ap.error("--profile measures the CUDA device; it does not run on the CPU")
    if args.profile and not spec.run.window:
        ap.error("--profile profiles windows; it does not run the host-driven loop (--window 0)")
    run_simulation(sim, spec)
    if args.profile:
        profile_window(sim, spec.run.window, graphs=True)
        profile_window(sim, spec.run.window, graphs=False)


def run_ranks(spec: SimSpec, n_ranks: int, device=None) -> None:
    """Run ``spec`` over ``n_ranks`` processes, one a rank, each holding its
    block of the mesh on its card (or on the CPU when ``device`` names it);
    rank 0 prints. The request is checked first (`check_rank_request`); a
    rank that fails makes this raise."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.distributed.ranks import check_rank_request

    on_cpu = device is not None and torch.device(device).type == "cpu"
    n_cards = None if on_cpu else (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    check_rank_request(n_ranks, spec.mesh.shape, n_cards=n_cards)
    store = tempfile.mkdtemp(prefix="pic_run_ranks_")
    try:
        mp.start_processes(_rank_main, args=(n_ranks, store, spec.to_json(), "cpu" if on_cpu else None),
                           nprocs=n_ranks, start_method="spawn")
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _rank_main(rank: int, world: int, store: str, spec_json: str, device) -> None:
    """One rank of `run_ranks`: join the group, build the driver on this
    rank's block, run it; rank 0 prints."""
    import torch.distributed as dist

    from repro_torch.distributed.ranks import close_ranks, init_ranks
    from repro_torch.pic.distributed import make_pic_mesh

    dev = init_ranks(rank, world, store, device=device)
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        spec = SimSpec.from_json(spec_json)
        sim = make_simulation(spec, mesh=make_pic_mesh(*spec.mesh.shape, dist.group.WORLD), device=dev)
        run_simulation(sim, spec, out=functools.partial(print, flush=True) if rank == 0 else (lambda *a, **k: None))
    finally:
        close_ranks()


def run_simulation(sim, spec: SimSpec, out=print) -> None:
    """A warm-up window, then the timed run of ``spec``'s steps; ``out``
    prints the header, the timed line, the energies and, on a card, the
    peak memory (over ranks, rank 0's card)."""
    dev = sim.device
    n_steps, window = spec.run.steps, spec.run.window or None
    n_parts = sim.diagnostics()["n_alive"]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    mesh = f", mesh {spec.mesh.shape[0]}x{spec.mesh.shape[1]}" if spec.mesh.shape else ""
    ranks = getattr(sim, "ranks", None)
    if ranks is not None:
        mesh += f" over {ranks.world} ranks ({ranks.px}x{ranks.py})"
    out(
        f"{spec.name}: grid {spec.grid.shape}, {n_parts} particles, order {spec.deposition.order}, "
        f"deposition {spec.deposition.mode}, gather {spec.deposition.resolved_gather}, sort {spec.sort.mode}, "
        f"backend {spec.deposition.backend}, {f'window {window}' if window else 'host-driven loop'}{mesh}, "
        f"device {dev} ({name})"
    )
    sim.run(min(window or 2, n_steps), window=window)  # warm-up
    reads0, windows0 = sim.host_reads, sim.windows
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    sim.run(n_steps, window=window)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    d = sim.diagnostics()
    reads = sim.host_reads - reads0
    per = f"host reads/window={reads / max(sim.windows - windows0, 1):.1f}" if window else \
        f"host reads/step={reads / n_steps:.2f}"
    growths = sim.growths if spec.mesh.shape else sim.growths["capacity"]
    comm = f" mesh {sim.sx}x{sim.sy} comm_stats={sim.comm_stats}" if spec.mesh.shape else ""
    out(
        f"{n_steps} steps in {dt:.3f}s ({1e3 * dt / n_steps:.3f} ms/step, "
        f"{d['n_alive'] * n_steps / dt:.3e} particle-steps/s); "
        f"sorts={sim.sorts} rebuilds={sim.rebuilds} growths={growths} {per} "
        f"halts={sim.halts} retries={sim.retries} restarts={sim.restarts}{comm}"
    )
    out(f"energies: field={d['field_energy']:.4e} kinetic={d['kinetic_energy']:.4e} total={d['total_energy']:.4e}")
    if dev.type == "cuda":
        out(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi) — no CUDA, no run;
2. build: the CUDA kernels of src/repro_torch/csrc, from source;
3. kernels against their plain PyTorch versions, at orders 1-3 on a small
   grid and at the main path's shapes (order 3, 128^3 cells, capacity 32),
   with each one's time, its plain version's, a one-call PyTorch
   yardstick's and the least time the card could take (its bound);
4. the main path at full size: `make_simulation(scenario("uniform",
   grid=(128,)*3, ppc=2, order=3, steps=32, window=16)).run()` — 16.8 M
   macro-particles, third-order (QSP) shapes — with launch counts, step
   time, peak memory, host reads, energies and charge conservation; then
   the same path with backend "cuda" (the packed deposition kernel);
5. the other backends at 32^3 ("cuda" and "torch" on the card) against the
   default "cuda_reduced" run;
6. lwfa at its registry size: laser, density step, dead particles, cap 48.

It prints the `kernels` JSON line, then, last, the device line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM data sheet, dense, at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12      # float32 on the CUDA cores (the kernels use no tensor cores)
FLOPS_PER_TAP = 8            # one B-spline tap: offset, |u|, branch, polynomial

RTOL = ATOL = 1e-5           # kernel vs plain version: float32, different summation order
MAIN = dict(grid=(128, 128, 128), ppc=2, order=3, steps=32, window=16)


def say(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events over `reps` calls after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(torch, got, want) -> float:
    """Largest |got - want|; fails beyond atol + rtol * |want|."""
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        fail("kernel output is not finite")
    bad = diff > ATOL + RTOL * want.abs()
    if bool(bad.any()):
        fail(f"kernel disagrees with its plain version: {int(bad.sum())} elements, max |diff| {float(diff.max()):.3e}")
    return float(diff.max())


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    import torch

    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device: the port's main path runs on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    kind = torch.cuda.get_device_name(0)
    say(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    from repro_torch import kernels
    from repro_torch.api import make_simulation, scenario
    from repro_torch.core import bin_slab_staging, build_bins, cell_index, max_guard, unified_support
    from repro_torch.kernels import build
    from repro_torch.kernels.deposition import ops as dep
    from repro_torch.kernels.deposition import ref as dep_ref
    from repro_torch.kernels.gather import ops as gat
    from repro_torch.kernels.gather import ref as gat_ref
    from repro_torch.pic import lorentz_gamma

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    say(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.BUILD_INFO['seconds']:.2f} s, "
        f"cached={build.BUILD_INFO['cached']})")
    for line in build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    # -- 3a. kernels vs plain versions at orders 1-3, small grid --------------
    gen = torch.Generator(device=dev).manual_seed(0)
    # the last case is a 256-cell column: the reduced kernel's accumulator
    # then needs more than the default 48 KB of shared memory
    for order, grid, n in ((1, (6, 5, 7), 1500), (2, (6, 5, 7), 1500), (3, (6, 5, 7), 1500), (3, (2, 2, 256), 6000)):
        g = max_guard(order)
        pos = torch.rand((n, 3), generator=gen, device=dev) * torch.tensor(grid, dtype=torch.float32, device=dev)
        vel = torch.randn((n, 3), generator=gen, device=dev)
        qw = torch.rand((n,), generator=gen, device=dev) + 0.5
        layout, of = build_bins(cell_index(pos, grid), torch.ones(n, dtype=torch.bool, device=dev),
                                n_cells=math.prod(grid), capacity=64)
        if int(of):
            fail("small-grid binning overflowed")
        slab, val = bin_slab_staging(pos, vel, qw, layout, grid_shape=grid)
        d = slab.d
        padded = torch.randn((6, *(k + 2 * g for k in grid)), generator=gen, device=dev)
        errs = (
            max_err(torch, dep.fused_bin_deposit(d, val, order=order), dep_ref.fused_bin_deposit_ref(d, val, order=order)),
            max_err(torch, dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid, guard=g),
                    dep_ref.fused_bin_deposit_reduced_ref(d, val, order=order, grid_shape=grid, guard=g)),
            max_err(torch, gat.fused_bin_gather(d, padded, grid_shape=grid, order=order, guard=g),
                    gat_ref.fused_gather_ref(d, padded, grid_shape=grid, order=order, guard=g)),
        )
        say(f"order {order}, grid {grid}: max |kernel - plain| packed {errs[0]:.2e}, reduced {errs[1]:.2e}, "
            f"gather {errs[2]:.2e} (tolerance {ATOL} + {RTOL}*|plain|)")

    # -- 3b. kernels at the main path's shapes ---------------------------------
    spec = scenario("uniform", **MAIN)
    order, shape = spec.deposition.order, spec.grid.shape
    g = max_guard(order)
    t, _ = unified_support(order)
    sim0 = make_simulation(spec)
    state = sim0.state
    p = state.particles
    v = p.u / lorentz_gamma(p.u)[:, None]
    slab, val = bin_slab_staging(p.pos, v, spec.charge * p.w * p.alive.float(), state.layout, grid_shape=shape)
    d, val = slab.d, val.contiguous()
    n_occ = int(slab.valid.sum())
    del sim0, state, p, v, slab
    padded = torch.randn((6, *(k + 2 * g for k in shape)), generator=gen, device=dev)
    c, cap, _ = d.shape
    nx, ny, nz = shape
    say(f"main-path shapes: {c} cells x cap {cap}, {n_occ} occupied slots, order {order} (T={t})")
    slab_bytes = 2 * d.numel() * 4
    w_flops = 6 * t * FLOPS_PER_TAP                      # six weight sets per slot
    dep_flops = n_occ * (w_flops + 3 * t + 3 * t * t + 2 * 3 * t**3)  # a, byz, 3 T^3 multiply-adds
    gat_flops = n_occ * (w_flops + 4 * t * t + 6 * (2 * t**3 + 2 * t))  # 4 byz, 6 x (H, wx-sum)
    results = {}

    def record(name, fn, plain, library, n_bytes, flops, reps, source, replaces):
        got, want = fn(), plain()
        err = max_err(torch, got, want)
        del got, want
        torch.cuda.empty_cache()
        ms = time_ms(torch, fn, reps)
        plain_ms = time_ms(torch, plain, 2)
        torch.cuda.empty_cache()
        lib_ms = library() if library is not None else None
        torch.cuda.empty_cache()
        b_ms, b_by = bound(n_bytes, flops)
        results[name] = dict(name=name, route="cuda", source=source, replaces=replaces, launches=None,
                             max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms)
        say(f"{name}: {ms:.3f} ms (plain {plain_ms:.3f} ms, library {lib_ms if lib_ms is None else f'{lib_ms:.3f} ms'}, "
            f"bound {b_ms:.3f} ms by {b_by}), max |kernel - plain| {err:.2e}")

    def deposit_operands():
        """A = w_x * val (3C, T, cap) and B = w_y (x) w_z (3C, cap, T*T),
        materialised for the bmm yardstick."""
        from repro_torch.core import shape_weights_window

        _, base = unified_support(order)
        a = torch.empty((3, c, t, cap), device=dev)
        b = torch.empty((3, c, cap, t * t), device=dev)
        for comp in range(3):
            w = [shape_weights_window(d[..., k], order, comp == k, n_taps=t, base=base) for k in range(3)]
            a[comp] = (w[0] * val[..., comp][..., None]).transpose(1, 2)
            b[comp] = (w[1][..., :, None] * w[2][..., None, :]).reshape(c, cap, t * t)
            del w
        return a.reshape(3 * c, t, cap), b.reshape(3 * c, cap, t * t)

    def deposit_library():
        """Timed once; both deposition kernels share the yardstick."""
        if "deposit" not in library_ms:
            a, b = deposit_operands()
            library_ms["deposit"] = time_ms(torch, lambda: torch.bmm(a, b), 3)
            del a, b
        return library_ms["deposit"]

    library_ms = {}

    record(
        "fused_bin_deposit_reduced", lambda: dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=shape, guard=g),
        lambda: dep_ref.fused_bin_deposit_reduced_ref(d, val, order=order, grid_shape=shape, guard=g),
        deposit_library, slab_bytes + nx * ny * 3 * (nz + 2 * g) * t * t * 4, dep_flops + c * 3 * t**3, 5,
        "src/repro_torch/csrc/fused_deposition.cu", "src/repro/kernels/deposition/kernel.py:290",
    )
    record(
        "fused_bin_deposit", lambda: dep.fused_bin_deposit(d, val, order=order),
        lambda: dep_ref.fused_bin_deposit_ref(d, val, order=order),
        deposit_library, slab_bytes + c * 3 * t**3 * 4, dep_flops, 5,
        "src/repro_torch/csrc/fused_deposition.cu", "src/repro/kernels/deposition/kernel.py:174",
    )

    def gather_library():
        """H = byz . G^T for the six components as one bmm:
        (6C, cap, T*T) x (6C, T*T, T), operands materialised."""
        from repro_torch.core import EB_STAGGERS, pack_neighborhoods, packed_axis_weights

        gt = pack_neighborhoods(padded, grid_shape=shape, order=order, guard=g).transpose(2, 3)  # (C, 6, T*T, T)
        gt = gt.transpose(0, 1).reshape(6 * c, t * t, t)
        byz = torch.empty((6, c, cap, t * t), device=dev)
        w = packed_axis_weights(d, order)
        for comp, st in enumerate(EB_STAGGERS):
            byz[comp] = (w[(1, st[1])][..., :, None] * w[(2, st[2])][..., None, :]).reshape(c, cap, t * t)
        del w
        byz = byz.reshape(6 * c, cap, t * t)
        torch.cuda.empty_cache()
        ms = time_ms(torch, lambda: torch.bmm(byz, gt), 3)
        del byz, gt
        return ms

    record(
        "fused_bin_gather", lambda: gat.fused_bin_gather(d, padded, grid_shape=shape, order=order, guard=g),
        lambda: gat_ref.fused_gather_ref(d, padded, grid_shape=shape, order=order, guard=g),
        gather_library, d.numel() * 4 + padded.numel() * 4 + c * cap * 6 * 4, gat_flops, 5,
        "src/repro_torch/csrc/fused_gather.cu", "src/repro/kernels/gather/kernel.py:154",
    )
    del d, val, padded
    torch.cuda.empty_cache()

    # -- 4. the main path at full size -----------------------------------------
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    sim = make_simulation(scenario("uniform", **MAIN))
    charge0 = float(torch.sum(sim.state.particles.w * sim.state.particles.alive))
    n0 = sim.diagnostics()["n_alive"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    diag = sim.diagnostics()
    charge1 = float(torch.sum(sim.state.particles.w * sim.state.particles.alive))
    steps = MAIN["steps"]
    say(f"main path: uniform {MAIN['grid']}, {n0} particles, order {MAIN['order']}, {steps} steps in {run_s:.3f} s: "
        f"{1e3 * run_s / steps:.2f} ms/step, {n0 * steps / run_s:.4e} particle-steps/s")
    say(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, host reads {sim.host_reads} in "
        f"{sim.windows} windows ({sim.host_reads / sim.windows:.1f}/window), sorts {sim.sorts}, "
        f"rebuilds {sim.rebuilds}, growths {sim.growths['capacity']}")
    say(f"  launches {counts}")
    say(f"  energies: field {diag['field_energy']:.6e} kinetic {diag['kinetic_energy']:.6e} "
        f"total {diag['total_energy']:.6e}; charge {charge0:.7e} -> {charge1:.7e}")
    if counts["fused_bin_deposit_reduced"] != steps or counts["fused_bin_gather"] != steps:
        fail(f"the main path did not launch the kernels once per step: {counts}")
    if not all(math.isfinite(diag[k]) for k in ("field_energy", "kinetic_energy")) or diag["field_energy"] <= 0:
        fail(f"energies not finite and positive: {diag}")
    if diag["step"] != steps or diag["n_alive"] != n0 or abs(charge1 - charge0) > 1e-5 * abs(charge0):
        fail("step count, particle count or total charge not conserved")
    results["fused_bin_deposit_reduced"]["launches"] = counts["fused_bin_deposit_reduced"]
    results["fused_bin_gather"]["launches"] = counts["fused_bin_gather"]
    del sim
    torch.cuda.empty_cache()

    # the same path through the packed deposition kernel (backend "cuda")
    kernels.reset_launch_counts()
    sim = make_simulation(scenario("uniform", **{**MAIN, "steps": 16}, backend="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    say(f"main path, backend cuda: 16 steps in {run_s:.3f} s ({1e3 * run_s / 16:.2f} ms/step), launches {counts}")
    if counts["fused_bin_deposit"] != 16 or counts["fused_bin_deposit_reduced"] != 0:
        fail(f"backend cuda did not run the packed deposition kernel once per step: {counts}")
    results["fused_bin_deposit"]["launches"] = counts["fused_bin_deposit"]
    del sim
    torch.cuda.empty_cache()

    # -- 5. the other backends at 32^3 against the default --------------------
    fields = {}
    for backend in ("cuda_reduced", "cuda", "torch"):
        kernels.reset_launch_counts()
        sim = make_simulation(scenario("uniform", grid=(32, 32, 32), ppc=2, order=3, steps=8, window=4, backend=backend))
        sim.run()
        fields[backend] = [f.clone() for f in sim.state.fields.all()]
        say(f"32^3 backend {backend}: sorts {sim.sorts}, launches {kernels.launch_counts()}, "
            f"energies {sim.diagnostics()['total_energy']:.6e}")
    worst = 0.0
    for backend in ("cuda", "torch"):
        for a, b in zip(fields[backend], fields["cuda_reduced"]):
            scale = float(b.abs().max())
            rel = float((a - b).abs().max()) / max(scale, 1e-30)
            worst = max(worst, rel)
    say(f"32^3 fields, cuda and torch against cuda_reduced after 8 steps: max |diff| / max |field| = {worst:.2e} "
        f"(tolerance 1e-4: the kernels and cuBLAS sum in different orders, compounded over the steps)")
    if worst > 1e-4:
        fail("backends disagree")

    # -- 6. lwfa at its registry size -------------------------------------------
    kernels.reset_launch_counts()
    sim = make_simulation(scenario("lwfa"))
    p = sim.state.particles
    charge0, n0 = float(torch.sum(p.w * p.alive)), sim.diagnostics()["n_alive"]
    sim.run(20)
    diag = sim.diagnostics()
    p = sim.state.particles
    charge1 = float(torch.sum(p.w * p.alive))
    say(f"lwfa {sim.config.grid.shape}: capacity {sim.config.capacity}, {n0} live of {p.n} particles, 20 steps, "
        f"sorts {sim.sorts} rebuilds {sim.rebuilds} growths {sim.growths['capacity']}, launches {kernels.launch_counts()}, "
        f"energies field {diag['field_energy']:.6e} kinetic {diag['kinetic_energy']:.6e}")
    if not (math.isfinite(diag["total_energy"]) and diag["n_alive"] == n0 and n0 < p.n
            and abs(charge1 - charge0) <= 1e-5 * abs(charge0) and diag["field_energy"] > 0):
        fail(f"lwfa run not sane: {diag}")

    say(f"total {time.perf_counter() - t_start:.1f} s")
    order_of = ("fused_bin_deposit", "fused_bin_deposit_reduced", "fused_bin_gather")
    say(json.dumps({"kernels": [results[k] for k in order_of]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

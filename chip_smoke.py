#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi) — no CUDA, no run;
2. build: the CUDA kernels of src/repro_torch/csrc, from source;
3. all six kernels against their plain PyTorch versions: (a) at orders
   1-3 on a small grid; the three fused kernels at capacity 48 with an
   all-gap and a full cell, on one-cell columns and on a 1000-cell column,
   the packed deposition bit for bit against its plain version, the reduced
   one bit for bit against the packed kernel + z pass, and both and the
   fused gather against their own repeated launches; the unfused kernels at
   the M and N of every stagger on an awkward cell count, at odd
   capacities and on operands off a 16-byte boundary (their element-copy
   route), and at an (M, N) outside the templated ones, in float32 and,
   for `bin_outer_product` and `segment_accumulate`, bfloat16;
   `bin_outer_product` also with all-zero cells, its two copy routes and
   two launches bit-equal; (b) at
   the main path's shapes (order 3,
   128^3 cells, capacity 32; `segment_accumulate` at the MoE combine of
   mixtral_8x22b and the embedding gradient of phi3_mini_3p8b), with each
   one's time, its plain version's, a one-call PyTorch yardstick's and the
   least time the card could take (its bound);
4. the main path at full size: `make_simulation(scenario("uniform",
   grid=(128,)*3, ppc=2, order=3, steps=32, window=16)).run()` — 16.8 M
   macro-particles, third-order (QSP) shapes — with launch counts, step
   time, peak memory, host reads per window (one: each window replays the
   step's CUDA graph), energies and charge conservation; then the same path
   with backend "cuda" (the packed deposition kernel);
5. the unfused path (`deposition="matrix_unfused"`, `gather=
   "matrix_unfused"`: 3 + 6 kernel launches a step) and the paper's scatter
   baseline at the same size;
6. the other backends and modes at 32^3 ("cuda" and "torch"; matrix_unfused,
   scatter, rhocell) against the default "cuda_reduced" run;
7. lwfa at its registry size: laser, density step, dead particles, cap 48;
8. `matrix_scatter_add` at the two language-model shapes of phase 3b;
9. the sort-mode ablation at the main shapes (window 8): ``rebuild`` and
   ``global`` on the default path, 8 steps after a warm-up window, and
   ``none`` with the scatter deposition and gather (the scatter baseline
   with no bin upkeep), 4 steps after a warm-up window; each against
   phase 4's ``incremental`` step time;
10. the host-driven loop (``window=None``): 8 steps of the main path, then
   at 32^3 20 host-loop steps bit-equal to 20 windowed steps (the
   performance trigger off);
11. checkpoints at 32^3: saved at step 10, loaded into a fresh driver and
   run 10 more steps, bit-equal to an uninterrupted 20-step run, in the
   ``incremental`` and ``global`` sort modes;
12. the two_stream and weibel growth rates at their registry sizes (300 and
   260 steps) within 0.75-1.25 of the analytic rates;
13. examples/torch_pm_nbody.py at its default size (4096 bodies, 16^3, 40
   steps): kernels #4 and #5 launched, finite energies, mass conserved.

The packed deposition's plain version is evaluated on the CPU wherever the
kernel is held to it bit for bit: PyTorch on CUDA divides by a Python
scalar as a multiply by its rounded reciprocal, so the third-order spline's
t^3 / 6 can differ there by one rounding from the kernel's (and the CPU's)
division.

It prints the `kernels` JSON line, then, last, the device line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import re
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
# kernels whose every instance must compile without spilling, and how
# many instances each has (orders 1-3; the unfused gather's N templates;
# the unfused deposition's M templates and run-time M, in both types)
NO_SPILLS = {"fused_deposit_kernel": 3, "fused_deposit_reduced_kernel": 3, "fused_gather_kernel": 3,
             "bin_gather_kernel": 8, "bin_outer_product_kernel": 10}
MAIN = dict(grid=(128, 128, 128), ppc=2, order=3, steps=32, window=16)
UNFUSED = dict(MAIN, steps=8, window=8, deposition="matrix_unfused", gather="matrix_unfused")
SCATTER = dict(MAIN, steps=4, window=4, deposition="scatter", gather="scatter")
# segment_accumulate at two language-model shapes (src/repro/configs):
# the MoE combine of mixtral_8x22b (8192 tokens, top-2 experts, d_model
# 6144: one bin per token, capacity 2) and the embedding gradient of
# phi3_mini_3p8b (8192 token ids, Zipf-like over its 32064-entry vocabulary,
# capacity 16, d_model 3072: the most frequent ids overflow their bins)
MOE = dict(tokens=8192, top_k=2, d=6144)
EMBED = dict(tokens=8192, vocab=32064, capacity=16, d=3072)


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
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        fail("kernel output is not finite")
    bad = diff > ATOL + RTOL * want.abs()
    if bool(bad.any()):
        fail(f"kernel disagrees with its plain version: {int(bad.sum())} elements, max |diff| {float(diff.max()):.3e}")
    return float(diff.max())


def exact(torch, got, want_cpu) -> float:
    """0.0 if got is bit-equal to want_cpu (a plain version evaluated on the
    CPU); fails otherwise."""
    if not torch.equal(got.cpu(), want_cpu):
        diff = (got.cpu() - want_cpu).abs()
        fail(f"kernel is not bit-equal to its plain version: {int((diff > 0).sum())} elements differ, "
             f"max |diff| {float(diff.max()):.3e}")
    return 0.0


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_report(log: str) -> dict[str, tuple[int, int]]:
    """(registers, spill stores + loads in bytes) per compiled entry
    function, from ptxas -v output."""
    out, fn, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out[fn] = (int(m.group(1)), spill)
            fn, spill = None, 0
    return out


def synthetic_slab(torch, grid, cap, gen, dev, *, empty=(), full=()):
    """A slab with a random occupancy per cell (cells ``empty`` hold no
    particle, ``full`` fill every slot); gap slots get val 0 and the offset
    of one aliased particle from their cell, as the port's slabs do."""
    n_cells = math.prod(grid)
    occ = torch.randint(0, cap + 1, (n_cells,), generator=gen, device=dev)
    occ[list(empty)] = 0
    occ[list(full)] = cap
    d = torch.rand((n_cells, cap, 3), generator=gen, device=dev)
    val = torch.randn((n_cells, cap, 3), generator=gen, device=dev)
    gap = torch.arange(cap, device=dev)[None, :] >= occ[:, None]
    val[gap] = 0.0
    idx = torch.arange(n_cells, device=dev)
    cells = torch.stack((idx // (grid[1] * grid[2]), (idx // grid[2]) % grid[1], idx % grid[2]), -1).float()
    alias = torch.rand(3, generator=gen, device=dev) * torch.tensor(grid, dtype=torch.float32, device=dev)
    d = torch.where(gap[..., None], (alias - cells)[:, None, :], d)
    return d.contiguous(), val.contiguous()


def run_path(torch, kernels, sim, label: str, n_steps: int | None = None, warmup: int = 0) -> dict:
    """Run a simulation from launch counts at 0, print its step time (with
    and without the CUDA graph's one-time set-up: a warm-up step and the
    capture), rate, peak memory, host reads and launches, and fail unless
    every window made one host read (two more per capacity growth). With
    ``warmup``, a first window of that many steps runs untimed (its
    launches and reads counted) and the steady state is the run after it;
    the time with the set-up then spans both."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n0 = sim.diagnostics()["n_alive"]
    kernels.reset_launch_counts()
    reads0, windows0, setup0, step0 = sim.host_reads, sim.windows, sim.graph_setup_seconds, sim.state.step
    t0 = time.perf_counter()
    if warmup:
        sim.run(warmup)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim.run(n_steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    steps = sim.state.step - step0
    timed = steps - warmup
    setup_s = sim.graph_setup_seconds - setup0
    windows, reads = sim.windows - windows0, sim.host_reads - reads0
    steady_s = t2 - t1 if warmup else t2 - t0 - setup_s
    out = dict(run_s=t2 - t0, setup_s=setup_s, steps=steps, n0=n0, counts=counts, captures=sim.graph_captures,
               ms_step=1e3 * steady_s / timed, ms_step_setup=1e3 * (t2 - t0) / steps,
               rate=n0 * timed / steady_s, reads_per_window=reads / max(windows, 1),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    say(f"{label}: {n0} particles, {steps} steps in {t2 - t0:.3f} s: {out['ms_step_setup']:.2f} ms/step with the "
        f"graph's set-up ({setup_s:.3f} s, {sim.graph_captures} capture(s)), {out['ms_step']:.2f} ms/step without"
        f"{f' (the {timed} steps after a {warmup}-step warm-up window)' if warmup else ''}, "
        f"{out['rate']:.4e} particle-steps/s")
    say(f"  peak memory {out['peak_gb']:.2f} GB, host reads {reads} in {windows} windows "
        f"({out['reads_per_window']:.2f}/window), sorts {sim.sorts}, rebuilds {sim.rebuilds}, "
        f"growths {sim.growths['capacity']}, launches {counts} (each capture's warm-up step launches once more)")
    if reads != windows + 2 * sim.growths["capacity"]:
        fail(f"{label}: {reads} host reads in {windows} windows with {sim.growths['capacity']} growths: "
             "expected one a window, two more a growth")
    return out


def same_state(torch, a, b, *, policy: bool = True) -> bool:
    """Two drivers' states, counters and (with ``policy``) device policy
    states bit for bit. The host-driven loop keeps its policy on the host,
    so its device policy state is not compared."""
    import dataclasses

    if (a.sorts, a.rebuilds, a.growths, a.state.step) != (b.sorts, b.rebuilds, b.growths, b.state.step):
        return False
    for part in ("fields", "particles", "layout", "slab"):
        x, y = getattr(a.state, part), getattr(b.state, part)
        if (x is None) != (y is None):
            return False
        if x is not None and not all(torch.equal(getattr(x, f.name), getattr(y, f.name))
                                     for f in dataclasses.fields(x)):
            return False
    return not policy or all(torch.equal(getattr(a.policy_state, f.name), getattr(b.policy_state, f.name))
                             for f in dataclasses.fields(a.policy_state))


def energy_slope(np, history, dt: float) -> float:
    """d ln(field energy)/dt fitted over the linear growth: past 100x the
    smallest energy, before 10% of the largest (tests/test_scenarios.py)."""
    t = np.array([h["step"] for h in history]) * dt
    e = np.array([h["field_energy"] for h in history])
    if not np.isfinite(e).all():
        fail("growth run: field energy not finite")
    lo, hi = e.min(), e.max()
    if hi <= 1e3 * lo:
        fail(f"growth run: no exponential growth, energy {lo:.2e}..{hi:.2e}")
    idx = np.where((e > lo * 100) & (e < hi * 0.1))[0]
    if len(idx) < 10:
        fail(f"growth run: linear window too short ({len(idx)} samples)")
    i0, i1 = idx[0], idx[-1]
    return float(np.polyfit(t[i0:i1 + 1], np.log(e[i0:i1 + 1]), 1)[0])


def main() -> None:
    import numpy as np
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
    from repro_torch.api import (
        SortPolicyConfig,
        load_simulation,
        make_simulation,
        scenario,
        two_stream_growth_rate,
        weibel_growth_rate,
    )
    from repro_torch.core import (
        CURRENT_STAGGER,
        EB_STAGGERS,
        NO_STAGGER,
        bin_items,
        bin_slab_staging,
        binned_shape_factors,
        build_bins,
        cell_coords,
        cell_index,
        extract_neighborhoods,
        matrix_scatter_add,
        max_guard,
        shape_weights,
        slot_gather,
        support,
        unified_support,
    )
    from repro_torch.kernels import build
    from repro_torch.kernels.deposition import ops as dep
    from repro_torch.kernels.deposition import ref as dep_ref
    from repro_torch.kernels.gather import ops as gat
    from repro_torch.kernels.gather import ref as gat_ref
    from repro_torch.kernels.scatter_matrix import ops as seg
    from repro_torch.kernels.scatter_matrix import ref as seg_ref
    from repro_torch.pic import lorentz_gamma

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    say(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.BUILD_INFO['seconds']:.2f} s, "
        f"cached={build.BUILD_INFO['cached']})")
    for line in build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")
    report = ptxas_report(build.BUILD_INFO["log"])
    for name, n_inst in NO_SPILLS.items():
        found = {f: r for f, r in report.items() if name in f}
        if len(found) != n_inst or any(spill for _, spill in found.values()):
            fail(f"{name}: expected {n_inst} instances with 0 spill bytes, ptxas reports {found}")
        say(f"  {name}, {n_inst} instances: registers {[r for r, _ in found.values()]}, spill bytes "
            f"{[s_ for _, s_ in found.values()]}")

    # -- 3a. kernels vs plain versions at orders 1-3, small grid --------------
    gen = torch.Generator(device=dev).manual_seed(0)
    # the last case is a 256-cell column (the first reduced kernel's shared
    # accumulator needed more than the default 48 KB there)
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
            exact(torch, dep.fused_bin_deposit(d, val, order=order),
                  dep_ref.fused_bin_deposit_ref(d.cpu(), val.cpu(), order=order)),
            max_err(torch, dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid, guard=g),
                    dep_ref.fused_bin_deposit_reduced_ref(d, val, order=order, grid_shape=grid, guard=g)),
            max_err(torch, gat.fused_bin_gather(d, padded, grid_shape=grid, order=order, guard=g),
                    gat_ref.fused_gather_ref(d, padded, grid_shape=grid, order=order, guard=g)),
        )
        say(f"order {order}, grid {grid}: max |kernel - plain| packed {errs[0]:.2e} (bit for bit, plain on the CPU), "
            f"reduced {errs[1]:.2e}, gather {errs[2]:.2e} (tolerance {ATOL} + {RTOL}*|plain|)")

    # the redesigned kernels at their edges: capacity 48 (a full and a
    # partial 32-slot chunk) with an all-gap cell and a full cell, on a grid
    # and on one-cell columns; a 1000-cell column; the packed kernel bit
    # equal to its plain version, the reduced kernel bit equal to the packed
    # kernel followed by the plain z pass, and every launch of the three
    # bit equal to the one before
    edge = [(order, grid, 48) for order in (1, 2, 3) for grid in ((5, 4, 6), (4, 3, 1))] + [(3, (1, 1, 1000), 8)]
    for order, grid, cap_e in edge:
        g = max_guard(order)
        d, val = synthetic_slab(torch, grid, cap_e, gen, dev, empty=(0,), full=(1,))
        padded = torch.randn((6, *(k + 2 * g for k in grid)), generator=gen, device=dev)
        reduced = dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid, guard=g)
        gathered = gat.fused_bin_gather(d, padded, grid_shape=grid, order=order, guard=g)
        errs = (max_err(torch, reduced, dep_ref.fused_bin_deposit_reduced_ref(d, val, order=order, grid_shape=grid,
                                                                             guard=g)),
                max_err(torch, gathered, gat_ref.fused_gather_ref(d, padded, grid_shape=grid, order=order, guard=g)))
        packed = dep.fused_bin_deposit(d, val, order=order)
        exact(torch, packed, dep_ref.fused_bin_deposit_ref(d.cpu(), val.cpu(), order=order))
        packed_z = dep_ref.column_z_pass(packed, order=order, grid_shape=grid, guard=g)
        if not torch.equal(reduced, packed_z):
            fail(f"order {order}, grid {grid}: the reduced kernel is not bit equal to the packed kernel + z pass")
        if not (torch.equal(reduced, dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=grid, guard=g))
                and torch.equal(gathered, gat.fused_bin_gather(d, padded, grid_shape=grid, order=order, guard=g))
                and torch.equal(packed, dep.fused_bin_deposit(d, val, order=order))):
            fail(f"order {order}, grid {grid}: two launches differ")
        say(f"order {order}, grid {grid}, cap {cap_e} (an all-gap and a full cell): max |kernel - plain| packed 0 "
            f"(bit for bit), reduced {errs[0]:.2e}, gather {errs[1]:.2e}; reduced == packed + z pass, launches "
            "repeat bit for bit")

    # the unfused kernels at the M x N of every stagger, on 1001 cells (no
    # block holds a whole number of them), random operands; both also at odd
    # capacities and on operands one element off a 16-byte boundary (their
    # element-copy route)
    def taps(order, stagger):
        t3 = [support(order, s)[0] for s in stagger]
        return t3[0], t3[1] * t3[2]

    def off16(x):
        """x copied to one element past a 16-byte boundary."""
        return torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape).copy_(x)

    def outer_check(cap_o, m, n, dtype):
        """bin_outer_product on 1001 cells, every seventh a cell all zero:
        its error against the plain version; fails unless operands off a
        16-byte boundary (the element route) and a second launch give the
        same bits"""
        a = torch.randn((n_awk, cap_o, m), generator=gen, device=dev)
        a[::7] = 0.0
        a, b = a.to(dtype), torch.randn((n_awk, cap_o, n), generator=gen, device=dev).to(dtype)
        got = dep.bin_outer_product(a, b)
        err = max_err(torch, got, dep_ref.bin_outer_product_ref(a, b))
        if not (torch.equal(dep.bin_outer_product(off16(a), off16(b)), got)
                and torch.equal(dep.bin_outer_product(a, b), got)):
            fail(f"bin_outer_product at cap {cap_o}, (M, N) ({m}, {n}), {dtype}: its copy routes or two launches "
                 "differ")
        return err

    n_awk, cap_awk = 1001, 32
    for order in (1, 2, 3):
        worst = {"bin_outer_product f32": 0.0, "bin_outer_product bf16": 0.0, "bin_gather": 0.0}
        for stagger in (NO_STAGGER,) + CURRENT_STAGGER:
            m, n = taps(order, stagger)
            for cap_o in (cap_awk, 7, 33, 48):
                for dtype, key in ((torch.float32, "bin_outer_product f32"),
                                   (torch.bfloat16, "bin_outer_product bf16")):
                    worst[key] = max(worst[key], outer_check(cap_o, m, n, dtype))
        for stagger in (NO_STAGGER,) + EB_STAGGERS:
            m, n = taps(order, stagger)
            for cap_g in (cap_awk, 7):
                wx = torch.rand((n_awk, cap_g, m), generator=gen, device=dev)
                byz = torch.rand((n_awk, cap_g, n), generator=gen, device=dev)
                gn = torch.randn((n_awk, m, n), generator=gen, device=dev)
                want = gat_ref.bin_gather_ref(wx, byz, gn)
                off = [off16(x) for x in (wx, byz, gn)]
                worst["bin_gather"] = max(worst["bin_gather"], max_err(torch, gat.bin_gather(wx, byz, gn), want),
                                          max_err(torch, gat.bin_gather(*off), want))
        say(f"order {order}, {n_awk} cells x cap {cap_awk} (bin_outer_product also caps 7, 33, 48, all-zero cells, "
            "its two copy routes and two launches bit-equal; the gather also cap 7), every stagger, aligned and off 16 "
            "bytes: max |kernel - plain| " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    # bin_outer_product's run-time-M instance: M outside the templated 2..5
    worst = max(outer_check(cap_o, m, n, dtype) for m, n in ((1, 4), (6, 16), (9, 5)) for cap_o in (cap_awk, 7)
                for dtype in (torch.float32, torch.bfloat16))
    say(f"bin_outer_product at (M, N) (1, 4), (6, 16) and (9, 5), {n_awk} cells x cap {cap_awk} and 7, f32 and bf16: "
        f"max |kernel - plain| {worst:.2e}; copy routes and launches bit-equal")
    # the gather's run-time-N instance: an N no stagger has, and an M over
    # the templated sums' 5
    worst = 0.0
    for m, n in ((3, 7), (6, 16)):
        for cap_g in (cap_awk, 7):
            wx = torch.rand((n_awk, cap_g, m), generator=gen, device=dev)
            byz = torch.rand((n_awk, cap_g, n), generator=gen, device=dev)
            gn = torch.randn((n_awk, m, n), generator=gen, device=dev)
            want = gat_ref.bin_gather_ref(wx, byz, gn)
            off = [off16(x) for x in (wx, byz, gn)]
            worst = max(worst, max_err(torch, gat.bin_gather(wx, byz, gn), want),
                        max_err(torch, gat.bin_gather(*off), want))
    say(f"bin_gather at (M, N) (3, 7) and (6, 16), {n_awk} cells x cap {cap_awk} and 7, aligned and off 16 bytes: "
        f"max |kernel - plain| {worst:.2e}")
    for v_, cap_, d_ in ((1001, 2, 333), (1001, 16, 1000)):
        for dtype in (torch.float32, torch.bfloat16):
            w_ = torch.randn((v_, cap_), generator=gen, device=dev).to(dtype)
            u_ = torch.randn((v_, cap_, d_), generator=gen, device=dev).to(dtype)
            err = max_err(torch, seg.segment_accumulate(w_, u_), seg_ref.segment_accumulate_ref(w_, u_))
            say(f"segment_accumulate ({v_}, {cap_}, {d_}) {str(dtype)[6:]}: max |kernel - plain| {err:.2e}")

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
    # what the unfused kernels' operands are built from
    main_pos, main_layout = p.pos, state.layout
    main_qwv = (spec.charge * p.w * p.alive.float())[:, None] * v
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
    # bit for bit against the plain version on the CPU, a slice of cells at
    # a time (each cell's tiles depend on that cell alone)
    packed = dep.fused_bin_deposit(d, val, order=order)
    for i in range(0, c, 1 << 18):
        sl = slice(i, i + (1 << 18))
        exact(torch, packed[sl], dep_ref.fused_bin_deposit_ref(d[sl].cpu(), val[sl].cpu(), order=order))
    del packed
    results["fused_bin_deposit"]["max_abs_err"] = 0.0
    say("main-path shapes: the packed kernel is bit equal to its plain version on the CPU")

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
    packed_z = dep_ref.column_z_pass(dep.fused_bin_deposit(d, val, order=order), order=order, grid_shape=shape,
                                     guard=g)
    if not torch.equal(dep.fused_bin_deposit_reduced(d, val, order=order, grid_shape=shape, guard=g), packed_z):
        fail("main-path shapes: the reduced kernel is not bit equal to the packed kernel + z pass")
    say("main-path shapes: the reduced kernel is bit equal to the packed kernel followed by the plain z pass")
    del d, val, padded, packed_z
    torch.cuda.empty_cache()

    def record_sum(name, builders, reps, source, replaces):
        """A kernel's row summed over several calls (a step's launches, or
        the shapes of a path): each builder makes one call's operands and
        returns (kernel, plain, library, bytes, flops, label)."""
        row = dict(name=name, route="cuda", source=source, replaces=replaces, launches=None, max_abs_err=0.0,
                   ms=0.0, kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
        t_bytes = t_ops = 0.0
        for build_call in builders:
            fn, plain, library, n_bytes, flops, label = build_call()
            got, want = fn(), plain()
            err = max_err(torch, got, want)
            del got, want
            torch.cuda.empty_cache()
            ms, plain_ms, lib_ms = time_ms(torch, fn, reps), time_ms(torch, plain, 2), time_ms(torch, library, reps)
            b_ms, b_by = bound(n_bytes, flops)
            say(f"  {name} {label}: {ms:.3f} ms (plain {plain_ms:.3f}, library {lib_ms:.3f}, bound {b_ms:.3f} by "
                f"{b_by}), max |kernel - plain| {err:.2e}")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"] += ms
            row["plain_ms"] += plain_ms
            row["library_ms"] += lib_ms
            t_bytes, t_ops = t_bytes + n_bytes, t_ops + flops
            del fn, plain, library
            torch.cuda.empty_cache()
        row["kernel_ms"] = row["ms"]
        row["bound_ms"], row["bound_by"] = bound(t_bytes, t_ops)
        results[name] = row
        say(f"{name}, {len(builders)} calls: {row['ms']:.3f} ms (plain {row['plain_ms']:.3f} ms, library "
            f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms by {row['bound_by']}), "
            f"max |kernel - plain| {row['max_abs_err']:.2e}")

    # the unfused deposition: one bin_outer_product per current component
    def outer_case(k):
        def make():
            stagger = CURRENT_STAGGER[k]
            a, b = binned_shape_factors(main_pos, main_qwv[:, k].contiguous(), main_layout, grid_shape=shape,
                                        order=order, stagger=stagger)
            a, b = a.contiguous(), b.contiguous()
            m, n = a.shape[2], b.shape[2]
            return (lambda: dep.bin_outer_product(a, b), lambda: dep_ref.bin_outer_product_ref(a, b),
                    lambda: torch.bmm(a.transpose(1, 2), b), 4 * (a.numel() + b.numel() + c * m * n),
                    n_occ * 2 * m * n, f"J{'xyz'[k]} (M {m}, N {n})")
        return make

    say(f"unfused kernels at the main path's shapes ({c} cells x cap {cap}, order {order}):")
    record_sum("bin_outer_product", [outer_case(k) for k in range(3)], 3,
               "src/repro_torch/csrc/bin_outer_product.cu", "src/repro/kernels/deposition/kernel.py:70")

    # the unfused gather: one bin_gather per field component
    fields_m = torch.randn((6, *(k + 2 * g for k in shape)), generator=gen, device=dev)
    cells_m = cell_coords(c, shape, device=dev)
    d_m = slot_gather(main_pos, main_layout.slots) - cells_m[:, None, :].float()

    def gather_case(k):
        def make():
            stagger = EB_STAGGERS[k]
            (tx, ty, tz), bases = zip(*(support(order, st) for st in stagger))
            neigh = extract_neighborhoods(fields_m[k], shape, taps=(tx, ty, tz), bases=bases, guard=g)
            neigh = neigh.reshape(c, tx, ty * tz).contiguous()
            wx = shape_weights(d_m[..., 0], order, stagger[0]).contiguous()
            wy, wz = (shape_weights(d_m[..., ax], order, stagger[ax]) for ax in (1, 2))
            byz = (wy[..., :, None] * wz[..., None, :]).reshape(c, cap, ty * tz).contiguous()
            del wy, wz
            m, n = tx, ty * tz
            return (lambda: gat.bin_gather(wx, byz, neigh), lambda: gat_ref.bin_gather_ref(wx, byz, neigh),
                    lambda: torch.sum(wx * torch.bmm(byz, neigh.transpose(1, 2)), dim=-1),
                    4 * (wx.numel() + byz.numel() + neigh.numel() + c * cap), n_occ * 2 * m * (n + 1),
                    f"{('Ex', 'Ey', 'Ez', 'Bx', 'By', 'Bz')[k]} (M {m}, N {n})")
        return make

    record_sum("bin_gather", [gather_case(k) for k in range(6)], 3,
               "src/repro_torch/csrc/bin_gather.cu", "src/repro/kernels/gather/kernel.py:67")
    del fields_m, cells_m, d_m, main_pos, main_layout, main_qwv
    torch.cuda.empty_cache()

    # segment_accumulate at the two language-model shapes, bfloat16
    def lm_items():
        """(label, indices, updates, weights, capacity, n_bins) of the MoE
        combine and the embedding gradient, made from seed 0."""
        rng = np.random.default_rng(0)
        t_moe = MOE["tokens"] * MOE["top_k"]
        moe = ("MoE combine, mixtral_8x22b", torch.arange(MOE["tokens"], device=dev).repeat_interleave(MOE["top_k"]),
               torch.randn((t_moe, MOE["d"]), generator=gen, device=dev).to(torch.bfloat16),
               torch.rand((t_moe,), generator=gen, device=dev).to(torch.bfloat16), MOE["top_k"], MOE["tokens"])
        zipf = 1.0 / np.arange(1, EMBED["vocab"] + 1)   # rank-frequency of word ids
        ids = rng.choice(EMBED["vocab"], size=EMBED["tokens"], p=zipf / zipf.sum())
        emb = ("embedding gradient, phi3_mini_3p8b", torch.from_numpy(ids).to(dev),
               torch.randn((EMBED["tokens"], EMBED["d"]), generator=gen, device=dev).to(torch.bfloat16), None,
               EMBED["capacity"], EMBED["vocab"])
        return moe, emb

    def segment_case(item):
        def make():
            label, idx, upd, wts, capacity, n_bins = item
            w, u, _, _ = bin_items(idx, upd, n_bins=n_bins, capacity=capacity, weights=wts)
            w, u = w.contiguous(), u.contiguous()
            v_, cap_, d_ = u.shape
            return (lambda: seg.segment_accumulate(w, u), lambda: seg_ref.segment_accumulate_ref(w, u),
                    lambda: torch.einsum("vc,vcd->vd", w, u), 2 * (w.numel() + u.numel() + v_ * d_),
                    2 * v_ * cap_ * d_, f"{label} ({v_} bins x cap {cap_} x D {d_}, bf16)")
        return make

    items = lm_items()
    record_sum("segment_accumulate", [segment_case(it) for it in items], 5,
               "src/repro_torch/csrc/segment_accumulate.cu", "src/repro/kernels/scatter_matrix/kernel.py:37")
    torch.cuda.empty_cache()

    # -- 4. the main path at full size -----------------------------------------
    sim = make_simulation(scenario("uniform", **MAIN))
    charge0 = float(torch.sum(sim.state.particles.w * sim.state.particles.alive))
    main = run_path(torch, kernels, sim, f"main path: uniform {MAIN['grid']}, order {MAIN['order']}")
    counts, steps, n0 = main["counts"], main["steps"], main["n0"]
    diag = sim.diagnostics()
    charge1 = float(torch.sum(sim.state.particles.w * sim.state.particles.alive))
    say(f"  energies: field {diag['field_energy']:.6e} kinetic {diag['kinetic_energy']:.6e} "
        f"total {diag['total_energy']:.6e}; charge {charge0:.7e} -> {charge1:.7e}")
    per_run = steps + main["captures"]  # each capture's warm-up step launches too
    if counts.get("fused_bin_deposit_reduced") != per_run or counts.get("fused_bin_gather") != per_run:
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
    sim = make_simulation(scenario("uniform", **{**MAIN, "steps": 16}, backend="cuda"))
    out = run_path(torch, kernels, sim, "main path, backend cuda")
    if out["counts"].get("fused_bin_deposit") != 16 + out["captures"] or out["counts"].get("fused_bin_deposit_reduced"):
        fail(f"backend cuda did not run the packed deposition kernel once per step: {out['counts']}")
    results["fused_bin_deposit"]["launches"] = out["counts"]["fused_bin_deposit"]
    del sim
    torch.cuda.empty_cache()

    # -- 5. the unfused path and the scatter baseline at full size -------------
    sim = make_simulation(scenario("uniform", **UNFUSED))
    out = run_path(torch, kernels, sim, "unfused path: matrix_unfused deposition and gather")
    per_run = out["steps"] + out["captures"]
    if out["counts"].get("bin_outer_product") != 3 * per_run or out["counts"].get("bin_gather") != 6 * per_run:
        fail(f"the unfused path did not launch bin_outer_product 3 and bin_gather 6 times a step: {out['counts']}")
    diag = sim.diagnostics()
    if not (math.isfinite(diag["total_energy"]) and diag["n_alive"] == out["n0"] and diag["field_energy"] > 0):
        fail(f"unfused run not sane: {diag}")
    results["bin_outer_product"]["launches"] = out["counts"]["bin_outer_product"]
    results["bin_gather"]["launches"] = out["counts"]["bin_gather"]
    say(f"  against the fused main path: {out['ms_step'] / main['ms_step']:.2f}x its step time, "
        f"{out['peak_gb'] / main['peak_gb']:.2f}x its peak memory")
    del sim
    torch.cuda.empty_cache()

    sim = make_simulation(scenario("uniform", **SCATTER))
    out = run_path(torch, kernels, sim, "scatter baseline: scatter deposition and gather")
    if out["counts"]:
        fail(f"the scatter baseline launched a bin kernel: {out['counts']}")
    diag = sim.diagnostics()
    if not (math.isfinite(diag["total_energy"]) and diag["n_alive"] == out["n0"] and diag["field_energy"] > 0):
        fail(f"scatter run not sane: {diag}")
    say(f"  the fused main path against this baseline: {out['ms_step'] / main['ms_step']:.2f}x faster a step")
    del sim
    torch.cuda.empty_cache()

    # -- 6. the other backends and modes at 32^3 against the default -----------
    fields = {}
    runs = {"cuda_reduced": {}, "cuda": dict(backend="cuda"), "torch": dict(backend="torch"),
            "matrix_unfused": dict(deposition="matrix_unfused", gather="matrix_unfused"),
            "scatter": dict(deposition="scatter", gather="scatter"),
            "rhocell": dict(deposition="rhocell", gather="scatter")}
    for label, kw in runs.items():
        kernels.reset_launch_counts()
        sim = make_simulation(scenario("uniform", grid=(32, 32, 32), ppc=2, order=3, steps=8, window=4, **kw))
        sim.run()
        fields[label] = [f.clone() for f in sim.state.fields.all()]
        say(f"32^3 {label}: sorts {sim.sorts}, host reads {sim.host_reads} in {sim.windows} windows, launches "
            f"{ {k: v for k, v in kernels.launch_counts().items() if v} }, energies {sim.diagnostics()['total_energy']:.6e}")
        if sim.host_reads != sim.windows + 2 * sim.growths["capacity"]:
            fail(f"32^3 {label}: not one host read a window")
    for label in runs:
        if label == "cuda_reduced":
            continue
        worst = 0.0
        for a, b in zip(fields[label], fields["cuda_reduced"]):
            worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
        say(f"32^3 fields, {label} against cuda_reduced after 8 steps: max |diff| / max |field| = {worst:.2e} "
            f"(tolerance 1e-4: the routes sum in different orders, compounded over the steps)")
        if worst > 1e-4:
            fail(f"{label} disagrees with the default path")

    # -- 7. lwfa at its registry size -------------------------------------------
    sim = make_simulation(scenario("lwfa"))
    p = sim.state.particles
    charge0 = float(torch.sum(p.w * p.alive))
    out = run_path(torch, kernels, sim, f"lwfa {sim.config.grid.shape}, capacity {sim.config.capacity}", 20)
    diag = sim.diagnostics()
    p = sim.state.particles
    charge1 = float(torch.sum(p.w * p.alive))
    say(f"  {out['n0']} live of {p.n} particles, energies field {diag['field_energy']:.6e} "
        f"kinetic {diag['kinetic_energy']:.6e}")
    if not (math.isfinite(diag["total_energy"]) and diag["n_alive"] == out["n0"] and out["n0"] < p.n
            and abs(charge1 - charge0) <= 1e-5 * abs(charge0) and diag["field_energy"] > 0):
        fail(f"lwfa run not sane: {diag}")
    del sim
    torch.cuda.empty_cache()

    # -- 8. matrix_scatter_add at the language-model shapes ----------------------
    # in float32 (the kernel rows above are bfloat16), against a float32
    # scatter-add of the same items: the two sum in different orders
    kernels.reset_launch_counts()
    for label, idx, upd, wts, capacity, n_bins in items:
        upd32 = upd.float()
        w32 = None if wts is None else wts.float()
        got = matrix_scatter_add(idx, upd32, n_bins=n_bins, capacity=capacity, weights=w32)
        ones = torch.ones(idx.shape, device=dev)
        want = torch.zeros((n_bins, upd.shape[1]), device=dev).index_add_(
            0, idx, (ones if w32 is None else w32)[:, None] * upd32)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        n_over = int((torch.bincount(idx, minlength=n_bins) > capacity).sum())
        say(f"matrix_scatter_add, {label}: {n_over} bins overflow capacity {capacity}, "
            f"max |path - scatter-add| {err:.3e} of max |out| {scale:.3e}")
        if not math.isfinite(err) or err > RTOL * scale:
            fail(f"matrix_scatter_add disagrees with the scatter-add: {label}")
        del got, want, upd32
    n_seg = kernels.launch_counts()["segment_accumulate"]
    if n_seg != len(items):
        fail(f"matrix_scatter_add did not launch segment_accumulate once per call: {n_seg}")
    results["segment_accumulate"]["launches"] = n_seg

    # -- 9. the sort-mode ablation at the main shapes ---------------------------
    ablation = {}
    for mode, kw, n_timed in (("rebuild", {}, 8), ("global", {}, 8),
                              ("none", dict(deposition="scatter", gather="scatter"), 4)):
        sim = make_simulation(scenario("uniform", **{**MAIN, "window": n_timed}, sort=mode, **kw))
        t0 = time.perf_counter()
        out = run_path(torch, kernels, sim, f"sort {mode}{' (scatter deposition and gather)' if kw else ''}",
                       n_timed, warmup=n_timed)
        per_run = out["steps"] + out["captures"]
        want = {} if mode == "none" else {"fused_bin_deposit_reduced": per_run, "fused_bin_gather": per_run}
        if out["counts"] != want:
            fail(f"sort {mode}: launches {out['counts']}, expected {want}")
        if out["reads_per_window"] != 1.0 or sim.sorts or sim.rebuilds:
            fail(f"sort {mode}: {out['reads_per_window']} host reads a window, {sim.sorts} sorts, "
                 f"{sim.rebuilds} rebuilds: expected 1.0 and no policy sort")
        diag = sim.diagnostics()
        if not (math.isfinite(diag["total_energy"]) and diag["n_alive"] == out["n0"] and diag["field_energy"] > 0):
            fail(f"sort {mode}: run not sane: {diag}")
        ablation[mode] = out
        say(f"  against incremental (phase 4): {out['ms_step'] / main['ms_step']:.3f}x its step time "
            f"({out['ms_step']:.2f} against {main['ms_step']:.2f} ms/step), {out['peak_gb'] / main['peak_gb']:.2f}x "
            f"its peak memory; phase {time.perf_counter() - t0:.1f} s")
        del sim
        torch.cuda.empty_cache()
    say("ablation (ms/step steady | with set-up | particle-steps/s | peak GB | host reads/window | ratio): "
        + "; ".join(f"{m} {o['ms_step']:.2f} | {o['ms_step_setup']:.2f} | {o['rate']:.4e} | {o['peak_gb']:.2f} | "
                    f"{o['reads_per_window']:.2f} | {o['ms_step'] / main['ms_step']:.3f}"
                    for m, o in [("incremental", main)] + list(ablation.items())))

    # -- 10. the host-driven loop ------------------------------------------------
    sim = make_simulation(scenario("uniform", **MAIN))
    sim.run(1, window=None)  # first-call allocations
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    reads0 = sim.host_reads
    t0 = time.perf_counter()
    sim.run(8, window=None)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / 8
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    host_reads = (sim.host_reads - reads0) / 8
    say(f"host-driven loop, main path: 8 steps at {host_ms:.2f} ms/step ({host_ms / main['ms_step']:.3f}x the "
        f"windowed {main['ms_step']:.2f}), {host_reads:.2f} host reads/step, sorts {sim.sorts}, launches {counts}, "
        f"{sim.graph_captures} graph captures")
    if counts != {"fused_bin_deposit_reduced": 8, "fused_bin_gather": 8} or sim.graph_captures or sim.windows:
        fail(f"the host-driven loop did not run each kernel once a step without a graph: {counts}")
    del sim
    torch.cuda.empty_cache()
    small = dict(grid=(32, 32, 32), ppc=2, order=3, policy=SortPolicyConfig(sort_interval=7, min_sort_interval=3,
                                                                          sort_trigger_perf_enable=False))
    host, wind = make_simulation(scenario("uniform", **small)), make_simulation(scenario("uniform", **small))
    host.run(20, window=None)
    wind.run(20, window=10)
    if not same_state(torch, host, wind, policy=False) or host.sorts < 2:
        fail(f"32^3: 20 host-loop steps are not bit-equal to 20 windowed steps (sorts {host.sorts}, {wind.sorts})")
    say(f"32^3: 20 host-loop steps bit-equal to 20 windowed steps: fields, particles, slots, slab, "
        f"sorts {host.sorts}, rebuilds {host.rebuilds}; host reads {host.host_reads} against {wind.host_reads}")
    del host, wind

    # -- 11. checkpoints on the card -------------------------------------------
    import shutil

    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoint"
    try:
        for mode in ("incremental", "global"):
            kw = dict(small, sort=mode, window=5, diagnostics_every=1)
            whole = make_simulation(scenario("uniform", **kw))
            whole.run(20)
            first = make_simulation(scenario("uniform", **kw))
            first.run(10)
            first.save(str(ckpt))
            kernels.reset_launch_counts()
            resumed = load_simulation(str(ckpt))
            resumed.run(10)
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            if not same_state(torch, whole, resumed) or whole.history != resumed.history:
                fail(f"sort {mode}: saved at step 10, loaded and run 10 more steps is not bit-equal to 20 steps")
            if counts.get("fused_bin_deposit_reduced", 0) < 10:
                fail(f"sort {mode}: the resumed run did not launch the kernels: {counts}")
            say(f"checkpoint, sort {mode}, 32^3: saved at step 10, loaded, 10 more steps bit-equal to 20 "
                f"uninterrupted steps (sorts {whole.sorts}, history of {len(whole.history)} steps)")
            del whole, first, resumed
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- 12. growth-rate anchors ------------------------------------------------
    for name, rate in (("two_stream", two_stream_growth_rate), ("weibel", weibel_growth_rate)):
        spec_g = scenario(name)
        kernels.reset_launch_counts()
        sim = make_simulation(spec_g)
        sim.run()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        gamma = rate(spec_g)
        slope = energy_slope(np, sim.history, spec_g.dt)
        ratio = slope / (2.0 * gamma)
        say(f"{name} {spec_g.grid.shape}, {spec_g.run.steps} steps: field-energy growth {slope:.4f} against the "
            f"analytic 2*gamma {2 * gamma:.4f}: ratio {ratio:.3f} (window 0.75-1.25), launches {counts}")
        if not 0.75 < ratio < 1.25 or not counts.get("fused_bin_gather"):
            fail(f"{name}: growth ratio {ratio:.3f} outside 0.75-1.25, or the kernels did not run")
        del sim

    # -- 13. the PM N-body example ------------------------------------------------
    import importlib.util

    spec_pm = importlib.util.spec_from_file_location(
        "torch_pm_nbody", Path(__file__).resolve().parent / "examples" / "torch_pm_nbody.py")
    pm = importlib.util.module_from_spec(spec_pm)
    spec_pm.loader.exec_module(pm)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = pm.run(4096, 40, device=dev, log=lambda line: say(f"  pm_nbody {line}"))
    pm_s = time.perf_counter() - t0
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    say(f"torch_pm_nbody: 4096 bodies, 16^3, 40 steps in {pm_s:.3f} s, launches {counts}, largest |deposited mass "
        f"- total| {out['mass_err']:.2e}, bin rebuilds {out['rebuilds']}, capacity growths {out['growths']}")
    energies = out["kinetic"] + out["potential"]
    if counts.get("bin_outer_product", 0) < 40 or counts.get("bin_gather", 0) < 120:
        fail(f"torch_pm_nbody did not launch bin_outer_product and bin_gather every step: {counts}")
    if not all(math.isfinite(e) for e in energies) or out["mass_err"] > 1e-5:
        fail(f"torch_pm_nbody: energies not finite or mass not conserved ({out['mass_err']:.2e})")

    say(f"total {time.perf_counter() - t_start:.1f} s")
    order_of = ("fused_bin_deposit", "fused_bin_deposit_reduced", "fused_bin_gather", "bin_outer_product",
                "bin_gather", "segment_accumulate")
    say(json.dumps({"kernels": [results[k] for k in order_of]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

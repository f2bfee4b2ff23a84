"""Time the unfused kernels at the main path's shapes and fingerprint their
outputs, on one CUDA device.

    python -m repro_torch.launch.kernel_bench [--reps 10] [--sweep]

Builds the operands the unfused path hands `bin_outer_product` (one call
per current component) and `bin_gather` (one per field component) on the
initial slab of the main cell (`uniform`, 128^3 cells, ppc 2, order 3, cap
32), then prints, per call, the kernel's device time (CUDA events over
``--reps`` calls after a warm-up call) and the SHA-256 of its output's
bytes. Two builds of the package give the same digests exactly when their
kernels give the same bits, so a tree can be held against another in one
process each: ``PYTHONPATH=<tree>/src python3 <this file>`` runs this script
on that tree's package. ``--sweep`` also times `bin_outer_product` at other
group sizes and stage counts than its geometry's (this tree's package only).
"""

from __future__ import annotations

import argparse
import hashlib
import math
import subprocess

import torch

# a named backend: only the initial state is used, so the driver's set-up
# need not time the dispatcher's candidates
MAIN = dict(grid=(128, 128, 128), ppc=2, order=3, steps=1, window=1, backend="cuda_reduced")


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def main_slab():
    """Positions, q*w*v and bin layout of the main cell's initial state."""
    from repro_torch.api import make_simulation, scenario
    from repro_torch.pic import lorentz_gamma

    spec = scenario("uniform", **MAIN)
    sim = make_simulation(spec)
    p = sim.state.particles
    v = p.u / lorentz_gamma(p.u)[:, None]
    qwv = (spec.charge * p.w * p.alive.float())[:, None] * v
    return spec, p.pos, qwv, sim.state.layout


def sweep_outer(a, b, reps: int) -> None:
    """bin_outer_product at the geometry's group halved and doubled and at
    every stage count that fits, launched directly (no launch count)."""
    from repro_torch.kernels.deposition import kernel
    from repro_torch.kernels.deposition import ops as dep

    n_cells, cap, m = a.shape
    n = b.shape[2]
    base = dep.bin_outer_product_geometry(n_cells, cap, m, n, a.dtype)
    header = dep.OUTER_HEADER if base.bulk else 0
    out = torch.empty((n_cells, m, n), dtype=torch.float32, device=a.device)
    for group in sorted({max(1, base.group // 2), base.group, 2 * base.group}):
        for stages in (1, 2, 3, 4):
            smem = header + stages * group * cap * (m + n) * a.element_size()
            if smem > dep.SMEM_LIMIT:
                continue
            threads = min(dep.OUTER_THREADS, max(32, (group * n + 31) // 32 * 32))
            per_sm = max(1, min(2048 // threads, dep.SM_SMEM // (smem + dep.SM_BLOCK_RESERVE)))
            geo = dep.OuterGeometry(n_cells, group, stages, threads, smem,
                                    min(math.ceil(n_cells / group), dep.SM_COUNT * per_sm), base.bulk)
            ms = time_ms(lambda: kernel.bin_outer_product_cuda(a, b, out, geometry=geo), reps)
            mark = " (the geometry's)" if geo == base else ""
            print(f"    group {group:3d} stages {stages} threads {threads} blocks {geo.blocks} smem {smem}: "
                  f"{ms:.4f} ms{mark}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sweep", action="store_true", help="time bin_outer_product at other launch geometries")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device: the kernels run on the GPU")
    import repro_torch
    from repro_torch.core import (
        CURRENT_STAGGER,
        EB_STAGGERS,
        binned_shape_factors,
        cell_coords,
        extract_neighborhoods,
        max_guard,
        shape_weights,
        slot_gather,
        support,
    )
    from repro_torch.kernels.deposition import ops as dep
    from repro_torch.kernels.gather import ops as gat

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(f"{smi[0] if smi else 'nvidia-smi: no output'}; package {repro_torch.__file__}", flush=True)
    spec, pos, qwv, layout = main_slab()
    order, shape = spec.deposition.order, spec.grid.shape
    c, cap = layout.slots.shape
    total = 0.0
    for k, stagger in enumerate(CURRENT_STAGGER):
        a, b = binned_shape_factors(pos, qwv[:, k].contiguous(), layout, grid_shape=shape, order=order,
                                    stagger=stagger)
        a, b = a.contiguous(), b.contiguous()
        ms = time_ms(lambda: dep.bin_outer_product(a, b), args.reps)
        total += ms
        print(f"bin_outer_product J{'xyz'[k]} ({c} cells x cap {cap}, M {a.shape[2]}, N {b.shape[2]}): {ms:.4f} ms, "
              f"sha256 {digest(dep.bin_outer_product(a, b))}", flush=True)
        if args.sweep:
            sweep_outer(a, b, args.reps)
        del a, b
        torch.cuda.empty_cache()
    print(f"bin_outer_product, 3 calls: {total:.4f} ms", flush=True)

    g = max_guard(order)
    gen = torch.Generator(device=pos.device).manual_seed(0)
    fields = torch.randn((6, *(s + 2 * g for s in shape)), generator=gen, device=pos.device)
    d = slot_gather(pos, layout.slots) - cell_coords(c, shape, device=pos.device)[:, None, :].float()
    total = 0.0
    for k, stagger in enumerate(EB_STAGGERS):
        (tx, ty, tz), bases = zip(*(support(order, st) for st in stagger))
        neigh = extract_neighborhoods(fields[k], shape, taps=(tx, ty, tz), bases=bases, guard=g)
        neigh = neigh.reshape(c, tx, ty * tz).contiguous()
        wx = shape_weights(d[..., 0], order, stagger[0]).contiguous()
        wy, wz = (shape_weights(d[..., ax], order, stagger[ax]) for ax in (1, 2))
        byz = (wy[..., :, None] * wz[..., None, :]).reshape(c, cap, ty * tz).contiguous()
        del wy, wz
        ms = time_ms(lambda: gat.bin_gather(wx, byz, neigh), args.reps)
        total += ms
        print(f"bin_gather {('Ex', 'Ey', 'Ez', 'Bx', 'By', 'Bz')[k]} (M {tx}, N {ty * tz}): {ms:.4f} ms, "
              f"sha256 {digest(gat.bin_gather(wx, byz, neigh))}", flush=True)
        del neigh, wx, byz
        torch.cuda.empty_cache()
    print(f"bin_gather, 6 calls: {total:.4f} ms", flush=True)


if __name__ == "__main__":
    main()

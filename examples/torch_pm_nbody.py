"""Appendix-B generalization on PyTorch: Particle-Mesh N-body gravity with
the same Matrix-PIC bin kernels as the plasma code (mass in place of
charge). Counterpart of examples/pm_nbody.py.

Mass deposition (`deposit_matrix`: the binned outer product, on the card
the `bin_outer_product` kernel) -> Poisson solve by FFT -> force gather
(`gather_matrix`: the binned matrix gather, on the card the `bin_gather`
kernel) -> kick and drift -> incremental re-sort (GPMA).

    PYTHONPATH=src python examples/torch_pm_nbody.py [--steps 40] [--n 4096]
    PYTHONPATH=src python examples/torch_pm_nbody.py --device cpu

Runs on the CUDA device unless ``--device`` names another. The bodies (two
gaussian clumps that fall together) are made with numpy from ``--seed``.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import resolve_device  # noqa: E402
from repro_torch.core import (  # noqa: E402
    build_bins,
    cell_index,
    choose_capacity,
    deposit_matrix,
    fold_guards,
    gather_matrix,
    gpma_update,
    max_guard,
    unfold_guards,
)
from repro_torch.pic.grid import GridSpec  # noqa: E402

ORDER = 1
GRID = GridSpec(shape=(16, 16, 16))
DT = 0.5


def make_bodies(n: int, grid: GridSpec = GRID, seed: int = 0):
    """Two gaussian clumps of n/2 bodies each, at rest up to a small random
    velocity, total mass 1: (pos, vel, mass) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    c1, c2 = np.array([5.0, 8.0, 8.0]), np.array([11.0, 8.0, 8.0])
    pos = np.concatenate([c1 + 1.2 * rng.normal(size=(n // 2, 3)), c2 + 1.2 * rng.normal(size=(n - n // 2, 3))])
    pos = np.mod(pos, np.asarray(grid.shape, np.float64)).astype(np.float32)
    vel = (0.02 * rng.normal(size=(n, 3))).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    return pos, vel, mass


def poisson_fft(rho: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """Solve nabla^2 phi = rho (G = 1/4pi absorbed) with a periodic FFT."""
    k = [torch.fft.fftfreq(n, device=rho.device) * 2 * math.pi for n in grid.shape]
    kx, ky, kz = torch.meshgrid(*k, indexing="ij")
    k2 = kx**2 + ky**2 + kz**2
    rho_k = torch.fft.fftn(rho)
    phi_k = torch.where(k2 > 0, -rho_k / torch.clamp_min(k2, 1e-12), torch.zeros((), dtype=rho_k.dtype,
                                                                                   device=rho.device))
    return torch.fft.ifftn(phi_k).real


def gradient(phi: torch.Tensor, axis: int) -> torch.Tensor:
    return (torch.roll(phi, -1, axis) - torch.roll(phi, 1, axis)) / 2.0


def pm_step(pos, vel, layout, mass, *, grid: GridSpec = GRID, dt: float = DT, backend: str = "auto"):
    """One PM step on tensors: returns (pos, vel, layout, GPMA stats, rho,
    phi), rho and phi at the step's start positions."""
    g = max_guard(ORDER)
    # 1. mass deposition: the binned outer product
    rho = fold_guards(deposit_matrix(pos, mass, layout, grid_shape=grid.shape, order=ORDER, backend=backend), g)
    rho = rho / grid.cell_volume
    # 2. field solve
    phi = poisson_fft(rho - torch.mean(rho), grid)
    # 3. force gather: the binned matrix gather of -grad phi
    acc = torch.stack([
        gather_matrix(pos, unfold_guards(-gradient(phi, ax), g), layout, grid_shape=grid.shape, order=ORDER,
                      backend=backend)
        for ax in range(3)
    ], dim=-1)
    # 4. kick, drift, incremental re-sort
    vel2 = vel + dt * acc
    pos2 = torch.remainder(pos + dt * vel2, torch.tensor(grid.shape, dtype=pos.dtype, device=pos.device))
    alive = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    layout2, stats = gpma_update(layout, cell_index(pos2, grid.shape), alive)
    return pos2, vel2, layout2, stats, rho, phi


def initial_capacity(pos: np.ndarray, grid: GridSpec = GRID) -> int:
    """Bin capacity for the densest cell of the initial bodies, with room to
    bunch."""
    counts = np.bincount(cell_index(torch.from_numpy(pos), grid.shape).numpy(), minlength=grid.n_cells)
    return choose_capacity(int(counts.max()), headroom=2.5)


def run(n: int = 4096, steps: int = 40, *, device=None, seed: int = 0, every: int = 10, log=print) -> dict:
    """The example's run; returns per-step energies, the largest error of the
    deposited mass, and the bin rebuilds and capacity growths it made."""
    device = resolve_device(device)
    pos_np, vel_np, mass_np = make_bodies(n, GRID, seed)
    cap = initial_capacity(pos_np)
    pos, vel, mass = (torch.from_numpy(a).to(device) for a in (pos_np, vel_np, mass_np))
    alive = torch.ones(n, dtype=torch.bool, device=device)
    layout, of = build_bins(cell_index(pos, GRID.shape), alive, n_cells=GRID.n_cells, capacity=cap)
    assert int(of) == 0
    total_mass = float(mass.double().sum())
    out = {"kinetic": [], "potential": [], "mass_err": 0.0, "rebuilds": 0, "growths": 0}
    for i in range(steps):
        pos, vel, layout, stats, rho, phi = pm_step(pos, vel, layout, mass)
        kinetic = 0.5 * float(torch.sum(mass[:, None] * vel * vel))
        potential = 0.5 * float(torch.sum((rho - rho.mean()) * phi)) * GRID.cell_volume
        deposited = float(rho.double().sum()) * GRID.cell_volume
        out["mass_err"] = max(out["mass_err"], abs(deposited - total_mass))
        out["kinetic"].append(kinetic)
        out["potential"].append(potential)
        if int(stats.n_overflow) > 0:
            # rebuild the bins; grow them when the densest cell outgrew them
            cells = cell_index(pos, GRID.shape)
            layout, of = build_bins(cells, alive, n_cells=GRID.n_cells, capacity=cap)
            out["rebuilds"] += 1
            if int(of) > 0:
                cap = max(choose_capacity(int(torch.bincount(cells, minlength=GRID.n_cells).max()), headroom=2.5),
                          2 * cap)
                layout, of = build_bins(cells, alive, n_cells=GRID.n_cells, capacity=cap)
                out["growths"] += 1
                assert int(of) == 0
        if every and i % every == 0:
            com = pos.mean(dim=0).tolist()
            log(f"step {i:3d}  max_rho={float(rho.max()):.3f}  moved={int(stats.n_moved)}  "
                f"com=({com[0]:.2f},{com[1]:.2f},{com[2]:.2f})  E_kin={kinetic:.4e}  E_pot={potential:.4e}")
    out["capacity"] = cap
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()
    out = run(args.n, args.steps, device=args.device, seed=args.seed)
    print(f"\nlargest |deposited mass - total mass| {out['mass_err']:.2e}; bin rebuilds {out['rebuilds']}, "
          f"capacity growths {out['growths']}")
    print("PM N-body with the Matrix-PIC deposition and gather kernels: OK")


if __name__ == "__main__":
    main()

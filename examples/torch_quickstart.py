"""Quickstart on PyTorch: a uniform thermal plasma simulated with the full
Matrix-PIC pipeline (fused matrix deposition, incremental GPMA sort,
adaptive re-sort), checked against the scatter baseline as it runs.
Counterpart of examples/quickstart.py: both runs are the same registry
scenario with different ablation overrides.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 50]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --steps 20

Runs on the CUDA device unless ``--device`` names another.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import make_simulation, scenario  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--grid", type=int, default=12)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()

    sims = {}
    for name, kw in [
        ("matrixpic", dict(deposition="matrix", sort="incremental")),
        ("baseline", dict(deposition="scatter", sort="none")),
    ]:
        # window=0: the loop below compares the fields after every step, so
        # each run takes the host-driven per-step loop
        spec = scenario(
            "uniform", grid=(args.grid,) * 3, u_thermal=0.05, perturb=None,
            dt=0.2, capacity=24, steps=args.steps, window=0, **kw,
        )
        sims[name] = make_simulation(spec, device=args.device)
    print(f"grid {spec.grid.shape}, {sims['matrixpic'].diagnostics()['n_alive']} macro-particles, "
          f"device {sims['matrixpic'].device}")

    for step in range(args.steps):
        for sim in sims.values():
            sim.run(1)
        if step % 10 == 0:
            d = sims["matrixpic"].diagnostics()
            err = float((sims["matrixpic"].state.fields.ex - sims["baseline"].state.fields.ex).abs().max())
            print(
                f"step {d['step']:4d}  E_field={d['field_energy']:.4e}  E_kin={d['kinetic_energy']:.4e}"
                f"  total={d['total_energy']:.4e}  |Ex_matrix - Ex_scatter|={err:.2e}"
            )

    d = sims["matrixpic"].diagnostics()
    print(f"\ndone: {args.steps} steps, {sims['matrixpic'].sorts} global sorts, "
          f"{sims['matrixpic'].rebuilds} overflow rebuilds")
    print(f"final total energy {d['total_energy']:.6e}")


if __name__ == "__main__":
    main()

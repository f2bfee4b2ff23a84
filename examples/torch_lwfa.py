"""Laser-wakefield acceleration on PyTorch (paper Fig. 9 scenario,
reduced): a gaussian pulse drives a wake in a density-profiled plasma; the
dense bunches and strong migration exercise the GPMA sorter and the
adaptive re-sort policy. Counterpart of examples/lwfa.py on one device,
built from the same `scenario("lwfa")` spec.

    PYTHONPATH=src python examples/torch_lwfa.py [--steps 60] [--window 10]
    PYTHONPATH=src python examples/torch_lwfa.py --device cpu --steps 20

Runs on the CUDA device unless ``--device`` names another; ``--window 0``
runs the host-driven per-step loop.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.api import make_simulation, scenario  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--window", type=int, default=10, help="steps per window; 0 = the host-driven per-step loop")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args()

    spec = scenario("lwfa", steps=args.steps, window=args.window)
    sim = make_simulation(spec, device=args.device)
    print(f"LWFA: grid {spec.grid.shape}, {sim.diagnostics()['n_alive']} plasma particles, a0={spec.laser.a0}, "
          f"device {sim.device}")

    # each block is one window (one host read); the field snapshot is read
    # at the window's end
    block = args.window if args.window > 0 else 10
    done = 0
    while done < args.steps:
        k = min(block, args.steps - done)
        sim.run(k)
        done += k
        d = sim.diagnostics()
        nx, ny, _ = spec.grid.shape
        ez = sim.state.fields.ez[nx // 2, ny // 2, :]
        print(
            f"step {d['step']:4d}  E_field={d['field_energy']:.3e}  E_kin={d['kinetic_energy']:.3e}"
            f"  max|Ez_axis|={float(ez.abs().max()):.3e}  sorts={sim.sorts} rebuilds={sim.rebuilds}"
        )

    umax = float(torch.linalg.norm(sim.state.particles.u, dim=-1).max())
    print(f"\nmax particle momentum u/mc = {umax:.3f} (wake acceleration signature)")


if __name__ == "__main__":
    main()

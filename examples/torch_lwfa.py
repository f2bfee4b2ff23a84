"""Laser-wakefield acceleration on PyTorch (paper Fig. 9 scenario,
reduced): a gaussian pulse drives a wake in a density-profiled plasma; the
dense bunches and strong migration exercise the GPMA sorter and the
adaptive re-sort policy. Counterpart of examples/lwfa.py, built from the
same `scenario("lwfa")` spec.

    PYTHONPATH=src python examples/torch_lwfa.py [--steps 60] [--window 10]
    PYTHONPATH=src python examples/torch_lwfa.py --device cpu --steps 20
    PYTHONPATH=src python examples/torch_lwfa.py --mesh 2x2   # domain-decomposed

Runs on the CUDA device unless ``--device`` names another; ``--window 0``
runs the host-driven per-step loop; ``--mesh SXxSY`` the distributed driver,
its SX x SY shards on that one device.
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
    ap.add_argument("--mesh", default=None, metavar="SXxSY",
                    help="run domain-decomposed on an SXxSY shard mesh (DistSimulation, every shard on the device)")
    args = ap.parse_args()

    spec = scenario("lwfa", steps=args.steps, window=args.window, mesh=args.mesh)
    sim = make_simulation(spec, device=args.device)
    mesh_note = f", mesh {args.mesh}" if args.mesh else ""
    print(f"LWFA: grid {spec.grid.shape}, {sim.diagnostics()['n_alive']} plasma particles, a0={spec.laser.a0}"
          f"{mesh_note}, device {sim.device}")

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
        fields = sim.fields_global() if args.mesh else sim.state.fields
        ez = fields.ez[nx // 2, ny // 2, :]
        print(
            f"step {d['step']:4d}  E_field={d['field_energy']:.3e}  E_kin={d['kinetic_energy']:.3e}"
            f"  max|Ez_axis|={float(ez.abs().max()):.3e}  sorts={sim.sorts} rebuilds={sim.rebuilds}"
        )

    u = sim.particles_global().u if args.mesh else sim.state.particles.u
    umax = float(torch.linalg.norm(u, dim=-1).max())
    print(f"\nmax particle momentum u/mc = {umax:.3f} (wake acceleration signature)")


if __name__ == "__main__":
    main()

"""Gradient-based design launcher of the port: optimize SimSpec leaves by
simulation. Counterpart of `repro.launch.pic_fit`.

    PYTHONPATH=src python -m repro_torch.launch.pic_fit --scenario lwfa \\
        --objective injected_charge --learn laser.a0,laser.duration \\
        --steps 20 --iters 10 --lr 0.05
    PYTHONPATH=src python -m repro_torch.launch.pic_fit --smoke
    PYTHONPATH=src python -m repro_torch.launch.pic_fit --smoke --device cpu

Builds the scenario's `SimSpec`, wraps it in a `GradSpec`
(--objective/--learn/--steps/--remat), and drives the AdamW loop of
`repro_torch.grad.fit.fit_simulation`, printing one line per iteration and,
with ``--out``, writing the whole trajectory (the serialized spec included)
as JSON. ``--checkpoint DIR`` makes the fit resumable: running the same
command again continues from the latest saved iteration (a directory the
reference's `pic_fit` wrote resumes too).

Runs on the CUDA device unless ``--device`` names another. The
differentiated window runs the ``torch`` backend, as the reference's runs
its ``xla`` one: the CUDA kernels have no backward.

``--smoke`` is the self-checking tiny LWFA fit (3 AdamW iterations): every
gradient finite, the loss decreasing, and the problem set up once.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from repro_torch.api import GradSpec, scenario, scenario_names
from repro_torch.grad.fit import fit_simulation
from repro_torch.grad.objectives import objective_names
from repro_torch.grad.params import LEARNABLE
from repro_torch.optim.adamw import AdamWConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scenario", default="lwfa", help=f"registered scenario to optimize ({scenario_names()})")
    p.add_argument("--objective", default="injected_charge", help=f"registered objective ({objective_names()})")
    p.add_argument("--learn", default="laser.a0",
                   help=f"comma-separated trainable SimSpec leaves ({sorted(LEARNABLE)}; aliases laser.w0/laser.tau)")
    p.add_argument("--steps", type=int, default=0, help="differentiated window length (0 = the spec's run.steps)")
    p.add_argument("--iters", type=int, default=8, help="AdamW iterations")
    p.add_argument("--remat", default="step", choices=("step", "chunk", "none"),
                   help="recomputation policy of the reverse pass")
    p.add_argument("--remat-chunk", type=int, default=0, help="sub-window length for --remat chunk (0 = spec window)")
    p.add_argument("--objective-kw", action="append", default=[], metavar="NAME=VALUE",
                   help="objective keyword override, repeatable (e.g. e_min=0.2)")
    # scenario shape overrides (the spec stays the source of truth)
    p.add_argument("--grid", type=int, nargs=3, default=None)
    p.add_argument("--ppc", type=int, default=None)
    p.add_argument("--order", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--capacity", type=int, default=None)
    # AdamW knobs
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--b1", type=float, default=0.9)
    p.add_argument("--b2", type=float, default=0.95)
    p.add_argument("--eps", type=float, default=1e-8)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--grad-clip", type=float, default=1.0)
    # plumbing
    p.add_argument("--checkpoint", metavar="DIR", default=None,
                   help="resumable {params, optimizer} checkpoints under DIR")
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--out", metavar="PATH", default=None,
                   help="write the fit trajectory (with serialized spec) as JSON")
    p.add_argument("--device", default=None, help="torch device (default: cuda, which must exist)")
    p.add_argument("--smoke", action="store_true", help="run the self-checking tiny-LWFA fit and exit")
    return p


def _spec_overrides(args) -> dict:
    ov = {"backend": "torch"}  # the differentiable window runs the plain route
    for name in ("ppc", "order", "seed", "capacity"):
        if getattr(args, name) is not None:
            ov[name] = getattr(args, name)
    if args.grid is not None:
        ov["grid"] = tuple(args.grid)
    return ov


def _objective_kwargs(pairs) -> tuple:
    out = []
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--objective-kw wants NAME=VALUE, got {pair!r}")
        name, value = pair.split("=", 1)
        try:
            value = float(value)
        except ValueError:
            pass
        out.append((name, value))
    return tuple(out)


def run_fit(args) -> int:
    spec = scenario(args.scenario, **_spec_overrides(args))
    gspec = GradSpec(
        objective=args.objective,
        learn=tuple(args.learn.split(",")),
        steps=args.steps,
        remat=args.remat,
        remat_chunk=args.remat_chunk,
        objective_kwargs=_objective_kwargs(args.objective_kw),
    )
    opt = AdamWConfig(lr=args.lr, b1=args.b1, b2=args.b2, eps=args.eps, weight_decay=args.weight_decay,
                      grad_clip=args.grad_clip)

    def show(r):
        pstr = " ".join(f"{k}={v:.5g}" for k, v in r["params"].items())
        print(f"iter {r['iter']:3d}  objective={r['objective']:.6g}  |grad|={r['grad_norm']:.3g}  {pstr}", flush=True)

    t0 = time.perf_counter()
    result = fit_simulation(spec, gspec, iters=args.iters, optimizer=opt, checkpoint_dir=args.checkpoint,
                            checkpoint_every=args.checkpoint_every, on_iteration=show, device=args.device)
    elapsed = time.perf_counter() - t0
    print(f"fit: {len(result.history)} iterations in {elapsed:.2f}s, {result.compiles} set-up(s); final "
          + " ".join(f"{k}={v:.6g}" for k, v in result.params.items()))
    if args.out:
        payload = {
            "spec": spec.to_dict(),
            "grad": result.grad.to_dict(),
            "optimizer": {f: getattr(opt, f) for f in opt.__dataclass_fields__},
            "iters": args.iters,
            "history": result.history,
            "final_params": result.params,
            "compiles": result.compiles,
            "elapsed_s": elapsed,
        }
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.out}")
    return 0


def run_smoke(device=None) -> int:
    """Tiny LWFA fit, 3 AdamW iterations: finite grads, a decreasing loss,
    one set-up."""
    spec = scenario("lwfa", grid=(6, 6, 24), ppc=1, backend="torch")
    t0 = time.perf_counter()
    result = fit_simulation(spec, learn=("laser.a0",), steps=6, iters=3, objective_kwargs={"e_min": 0.1},
                            device=device)
    elapsed = time.perf_counter() - t0
    ok = True
    for r in result.history:
        if not all(math.isfinite(g) for g in r["grads"].values()):
            print(f"FAIL: iteration {r['iter']} has non-finite grads: {r['grads']}")
            ok = False
    losses = [r["loss"] for r in result.history]
    if not losses[-1] < losses[0]:
        print(f"FAIL: loss did not decrease over the fit: {losses}")
        ok = False
    if result.compiles != 1:
        print(f"FAIL: the problem was set up {result.compiles} times (wanted exactly 1)")
        ok = False
    print(f"pic_fit smoke: {len(losses)} iters, objective {result.history[0]['objective']:.4g} -> "
          f"{result.history[-1]['objective']:.4g}, {result.compiles} set-up(s), {elapsed:.2f}s -> "
          f"{'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.smoke:
        return run_smoke(args.device)
    return run_fit(args)


if __name__ == "__main__":
    sys.exit(main())

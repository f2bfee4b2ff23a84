"""The language-model stack's distributed pieces on one device, every mesh
axis stacked: GPipe over 4 stacked stages against the sequential
composition of the stages, and data-parallel training of a linear model
over 8 stacked data shards, the int8 error-feedback all-reduce against the
exact mean. Counterpart of checks B and C of tests/dist_lm_check.py, on
inputs made with numpy from a seed.

    PYTHONPATH=src python examples/torch_dist_lm.py --device cpu

Runs on the CUDA device unless ``--device cpu``.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    compressed_psum_grads,
    exact_pmean_grads,
    zeros_like_residual,
)
from repro_torch.distributed.pipeline import pipeline_forward  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update_  # noqa: E402

STAGES, MICRO, MB, D = 4, 8, 4, 16        # check B
SHARDS, STEPS, ROWS = 8, 60, 64           # check C: 8 rows a shard a step
DP_OPT = AdamWConfig(lr=1e-2, weight_decay=0.0)


def pipeline_inputs(seed: int = 1):
    """Check B's stage weights (S, D, D) and microbatches (M, mb, D)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(STAGES, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(MICRO, MB, D)).astype(np.float32)
    return w, x


def tanh_stage(wi, x):
    return torch.tanh(x @ wi)


def pipeline_check(w, x):
    """(the pipelined output, the sequential composition of the stages)."""
    got = pipeline_forward(w, x, tanh_stage, mesh={"pipe": w.shape[0]})
    ref = x
    for i in range(w.shape[0]):
        ref = tanh_stage(w[i], ref)
    return got, ref


def dp_inputs(seed: int = 2):
    """Check C's initial weights, target weights and the STEPS batches."""
    rng = np.random.default_rng(seed)
    w0 = (rng.normal(size=(D, D)) * 0.3).astype(np.float32)
    w_true = (rng.normal(size=(D, D)) * 0.5).astype(np.float32)
    xs = rng.normal(size=(STEPS, ROWS, D)).astype(np.float32)
    return w0, w_true, xs


def loss(w, x, w_true):
    """A linearly realizable target: mean((x w - x w_true)^2)."""
    return torch.mean((x @ w - x @ w_true) ** 2)


def local_grads(w, x, w_true):
    """Each data shard's gradient of its own loss, stacked: (SHARDS, D, D)."""
    xs = x.reshape(SHARDS, -1, D)
    w_rep = w.detach().expand(SHARDS, D, D).clone().requires_grad_(True)
    total = ((xs @ w_rep - xs @ w_true) ** 2).mean(dim=(1, 2)).sum()
    return torch.autograd.grad(total, w_rep)[0]


def dp_update_(w, opt, res, g_local, compress: bool):
    """Reduce the stacked local gradients and take one AdamW step into ``w``
    and ``opt``. Returns the reduced gradient and the new residuals."""
    if compress:
        g, res = compressed_psum_grads(g_local, res)
    else:
        g = exact_pmean_grads(g_local)
    adamw_update_(g, opt, w, DP_OPT)
    return g, res


def dp_run(compress: bool, device, seed: int = 2) -> list[float]:
    """STEPS data-parallel steps; the loss on each step's batch after its
    update."""
    w0, w_true, xs = dp_inputs(seed)
    w = torch.from_numpy(w0).to(device)
    w_true = torch.from_numpy(w_true).to(device)
    opt = adamw_init(w)
    res = zeros_like_residual(w.expand(SHARDS, D, D))
    losses = []
    for i in range(STEPS):
        x = torch.from_numpy(xs[i]).to(device)
        _, res = dp_update_(w, opt, res, local_grads(w, x, w_true), compress)
        losses.append(float(loss(w, x, w_true)))
    return losses


def dp_criteria(exact: list[float], comp: list[float]) -> bool:
    """The reference's criteria: the compressed run's last loss below 0.2 of
    its first, and below 1.5 x the exact run's last plus 1e-3."""
    return comp[-1] < comp[0] * 0.2 and comp[-1] < exact[-1] * 1.5 + 1e-3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)

    w, x = (torch.from_numpy(a).to(device) for a in pipeline_inputs())
    got, ref = pipeline_check(w, x)
    err = float((got - ref).abs().max())
    print(f"B pipeline: {STAGES} stages, {MICRO} microbatches of {MB} x {D}: max |pipelined - sequential| {err:.2e}")

    exact, comp = dp_run(False, device), dp_run(True, device)
    ok = dp_criteria(exact, comp)
    print(f"C compressed DP over {SHARDS} shards, {STEPS} steps: loss {comp[0]:.4f} -> {comp[-1]:.4f} "
          f"(exact mean: {exact[0]:.4f} -> {exact[-1]:.4f}) {'OK' if ok else 'FAILED'}")
    if err > 1e-5 or not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

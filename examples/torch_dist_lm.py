"""The language-model stack's distributed pieces: GPipe over 4 stages
against the sequential composition of the stages, and data-parallel
training of a linear model over 8 data shards, the int8 error-feedback
all-reduce against the exact mean. Counterpart of checks B and C of
tests/dist_lm_check.py, on inputs made with numpy from a seed.

    PYTHONPATH=src python examples/torch_dist_lm.py --device cpu
    PYTHONPATH=src python examples/torch_dist_lm.py --ranks 4 --device cpu
    PYTHONPATH=src python examples/torch_dist_lm.py --mesh 2x2 --device cpu

Runs on the CUDA device unless ``--device cpu``. Without ``--ranks`` every
mesh axis is stacked on the one device. With ``--ranks N`` (N dividing 4)
it spawns N processes, one a rank (NCCL with one card a rank, gloo with
``--device cpu``), joined through a ``FileStore`` in a temporary
directory: each holds a block of the stages and of the data shards, and
rank 0 also runs the stacked checks and holds the ranks' results to them
bit for bit.

With ``--mesh DxM`` it spawns D·M ranks laid out as a (data, model) mesh
(`distributed.ranks.mesh_ranks`) and trains phi3-mini-3.8b's smoke config
3 steps through the tensor- and vocabulary-parallel step, each rank on its
blocks and its data shard; rank 0 holds the run to the one-process step at
``microbatches = D``: every metric within rtol 1e-5 (``tokens`` and
``accuracy`` exact), the gathered parameters within rtol 2e-3 and atol
2e-5 (check A's).
"""

import argparse
import os
import shutil
import sys
import tempfile
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
from repro_torch.tree import tree_leaves  # noqa: E402

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


def pipeline_check(w, x, ranks=None):
    """(the pipelined output, the sequential composition of the stages).
    Over ``ranks`` (the pipe axis) this rank runs its block of ``w``'s
    stages; the output is on every rank."""
    stages = w if ranks is None else ranks.block(w)
    got = pipeline_forward(stages, x, tanh_stage, mesh={"pipe": w.shape[0]}, ranks=ranks)
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


def local_grads(w, x, w_true, ranks=None):
    """Each data shard's gradient of its own loss, stacked: (SHARDS, D, D),
    or over ``ranks`` (the data axis) this rank's block of the shards."""
    xs = x.reshape(SHARDS, -1, D)
    if ranks is not None:
        xs = ranks.block(xs)
    w_rep = w.detach().expand(xs.shape[0], D, D).clone().requires_grad_(True)
    total = ((xs @ w_rep - xs @ w_true) ** 2).mean(dim=(1, 2)).sum()
    return torch.autograd.grad(total, w_rep)[0]


def dp_update_(w, opt, res, g_local, compress: bool, ranks=None):
    """Reduce the stacked local gradients (over ``ranks``, this rank's
    block) and take one AdamW step into ``w`` and ``opt``. Returns the
    reduced gradient and the new residuals."""
    if compress:
        g, res = compressed_psum_grads(g_local, res, ranks)
    else:
        g = exact_pmean_grads(g_local, ranks)
    adamw_update_(g, opt, w, DP_OPT)
    return g, res


def dp_run(compress: bool, device, seed: int = 2) -> list[float]:
    """STEPS data-parallel steps, stacked; the loss on each step's batch
    after its update."""
    return dp_train(compress, device, seed)[0]


def dp_train(compress: bool, device, seed: int = 2, ranks=None):
    """STEPS data-parallel steps; the loss on each step's batch after its
    update, and the final weights and residuals (over ``ranks``, this
    rank's block of them)."""
    w0, w_true, xs = dp_inputs(seed)
    w = torch.from_numpy(w0).to(device)
    w_true = torch.from_numpy(w_true).to(device)
    opt = adamw_init(w)
    res = zeros_like_residual(w.expand(SHARDS if ranks is None else ranks.n_local, D, D))
    losses = []
    for i in range(STEPS):
        x = torch.from_numpy(xs[i]).to(device)
        _, res = dp_update_(w, opt, res, local_grads(w, x, w_true, ranks), compress, ranks)
        losses.append(float(loss(w, x, w_true)))
    return losses, w, res


def dp_criteria(exact: list[float], comp: list[float]) -> bool:
    """The reference's criteria: the compressed run's last loss below 0.2 of
    its first, and below 1.5 x the exact run's last plus 1e-3."""
    return comp[-1] < comp[0] * 0.2 and comp[-1] < exact[-1] * 1.5 + 1e-3


def checks(device, pipe=None, data=None) -> bool:
    """Checks B and C (over ``pipe`` and ``data``, a rank's `AxisRanks`, or
    stacked); prints on rank 0, and there, over ranks, holds the ranks'
    results to the stacked runs bit for bit. True if every check held."""
    say = print if pipe is None or pipe.rank == 0 else (lambda *a, **k: None)
    w, x = (torch.from_numpy(a).to(device) for a in pipeline_inputs())
    got, ref = pipeline_check(w, x, pipe)
    err = float((got - ref).abs().max())
    say(f"B pipeline: {STAGES} stages, {MICRO} microbatches of {MB} x {D}: max |pipelined - sequential| {err:.2e}")
    runs = {c: dp_train(c, device, ranks=data) for c in (False, True)}
    exact, comp = runs[False][0], runs[True][0]
    ok = err <= 1e-5 and dp_criteria(exact, comp)
    say(f"C compressed DP over {SHARDS} shards, {STEPS} steps: loss {comp[0]:.4f} -> {comp[-1]:.4f} "
        f"(exact mean: {exact[0]:.4f} -> {exact[-1]:.4f}) {'OK' if ok else 'FAILED'}")
    if pipe is None:
        return ok
    res = {c: data.gather(runs[c][2]) for c in (False, True)}
    if pipe.rank == 0:
        stacked = {c: dp_train(c, device) for c in (False, True)}
        same = (torch.equal(got, pipeline_check(w, x)[0])
                and all(runs[c][0] == stacked[c][0] and torch.equal(runs[c][1], stacked[c][1])
                        and torch.equal(res[c], stacked[c][2]) for c in (False, True)))
        say(f"over {pipe.world} ranks ({pipe.n_local} of the {STAGES} stages and {data.n_local} of the {SHARDS} data "
            f"shards a rank): the pipeline, both runs' losses, weights and residuals bit-equal to the stacked runs: "
            f"{same}")
        ok = ok and same
    return bool(pipe.agree(int(ok)))


def _rank_main(rank: int, world: int, store: str, device) -> None:
    """One rank of ``--ranks``: join the group, run the checks on this
    rank's blocks; a failed check raises."""
    import torch.distributed as dist

    from repro_torch.distributed.ranks import AxisRanks, close_ranks, init_ranks

    dev = init_ranks(rank, world, store, device=device)
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        ok = checks(dev, AxisRanks.of_group("pipe", STAGES, dist.group.WORLD),
                    AxisRanks.of_group("data", SHARDS, dist.group.WORLD))
    finally:
        close_ranks()
    if not ok:
        raise SystemExit(1)


def run_ranks(n_ranks: int, device=None) -> None:
    """Checks B and C over ``n_ranks`` spawned processes; refuses, by name,
    more ranks than visible cards and a count that does not divide the
    stages or the shards."""
    import torch.multiprocessing as mp

    from repro_torch.distributed.ranks import check_axis_request

    on_cpu = device is not None and torch.device(device).type == "cpu"
    n_cards = None if on_cpu else (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    check_axis_request(n_ranks, STAGES, n_cards=n_cards, axis="pipe")
    check_axis_request(n_ranks, SHARDS, axis="data")
    store = tempfile.mkdtemp(prefix="torch_dist_lm_")
    try:
        mp.start_processes(_rank_main, args=(n_ranks, store, "cpu" if on_cpu else None), nprocs=n_ranks,
                           start_method="spawn")
    finally:
        shutil.rmtree(store, ignore_errors=True)


TP = dict(arch="phi3-mini-3.8b", steps=3, batch=4, seq=16)
TP_METRIC_RTOL, TP_PARAM_RTOL, TP_PARAM_ATOL = 1e-5, 2e-3, 2e-5


def tp_train(device, mesh=None, microbatches: int = 1):
    """``TP``'s steps of its smoke config (seed 0, the synthetic batches,
    check A's optimizer): over ``mesh`` (a `MeshRanks` layout) on this
    rank's blocks and data shard, else the one-process step at
    ``microbatches``. Returns (each step's metrics, the whole parameters;
    gathered over the model ranks, a collective)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data import DataConfig, global_batch_at, shard_batch_at
    from repro_torch.optim import ScheduleConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.step import state_blocks

    cfg = get_smoke_config(TP["arch"])
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), schedule=ScheduleConfig(warmup_steps=2, total_steps=50),
                       microbatches=microbatches)
    step = make_train_step(cfg, tcfg, mesh)
    state = init_train_state(torch.Generator(device=device).manual_seed(0), cfg, device=device, rules=step.rules)
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=TP["batch"], seq_len=TP["seq"])
    metrics = []
    for i in range(TP["steps"]):
        batch = (global_batch_at(i, data, device=device) if mesh is None
                 else shard_batch_at(i, data, mesh.data.rank, mesh.data.world, device=device))
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, (state if mesh is None else state_blocks(cfg, step.rules).gather(state))["params"]


def tp_check(device, mesh) -> bool:
    """The tensor-parallel run over ``mesh``, held on rank 0 to the
    one-process step at ``microbatches = D``; prints there. True on every
    rank if it held."""
    got, params = tp_train(device, mesh)
    ok = True
    if mesh.rank == 0:
        d, m = mesh.shape
        want, w_params = tp_train(device, microbatches=d)
        worst = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-6) for g, w in zip(got, want) for k in w)
        exact = all(g[k] == w[k] for g, w in zip(got, want) for k in ("tokens", "accuracy"))
        close = all(torch.allclose(a, b, rtol=TP_PARAM_RTOL, atol=TP_PARAM_ATOL)
                    for a, b in zip(tree_leaves(params), tree_leaves(w_params)))
        ok = worst <= TP_METRIC_RTOL and exact and close
        print(f"TP {TP['arch']} smoke over a {d}x{m} mesh ({d * m} ranks), {TP['steps']} steps: losses "
              + " ".join(f"{g['loss']:.6f}" for g in got) + " (one process at microbatches="
              f"{d}: " + " ".join(f"{w['loss']:.6f}" for w in want) + f"); largest metric rtol {worst:.2e}, tokens and "
              f"accuracy exact {exact}, parameters within rtol {TP_PARAM_RTOL} atol {TP_PARAM_ATOL} {close}: "
              f"{'OK' if ok else 'FAILED'}", flush=True)
    return bool(mesh.agree(int(ok)))


def _tp_rank_main(rank: int, world: int, store: str, shape, device) -> None:
    """One rank of ``--mesh``: join the group, lay out the mesh, run
    `tp_check`; a failed check raises."""
    from repro_torch.distributed.ranks import close_ranks, init_ranks, mesh_ranks

    dev = init_ranks(rank, world, store, device=device)
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        ok = tp_check(dev, mesh_ranks(*shape))
    finally:
        close_ranks()
    if not ok:
        raise SystemExit(1)


def run_mesh(text: str, device=None) -> None:
    """`tp_check` over the D·M ranks of the ``DxM`` mesh ``text``;
    refuses, by name, more ranks than visible cards."""
    import torch.multiprocessing as mp

    from repro_torch.distributed.ranks import check_axis_request

    d, m = (int(x) for x in text.split("x"))
    on_cpu = device is not None and torch.device(device).type == "cpu"
    n_cards = None if on_cpu else (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    check_axis_request(d * m, d, n_cards=n_cards, model=m)
    if TP["batch"] % d:
        raise ValueError(f"a data axis of {d} does not split the batch of {TP['batch']}")
    store = tempfile.mkdtemp(prefix="torch_dist_lm_tp_")
    try:
        mp.start_processes(_tp_rank_main, args=(d * m, store, (d, m), "cpu" if on_cpu else None), nprocs=d * m,
                           start_method="spawn")
    finally:
        shutil.rmtree(store, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=None, metavar="N",
                    help="spread the stages and the data shards over N processes, one a rank")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="train over a (data, model) mesh of D·M processes, one a rank, against one process")
    args = ap.parse_args()
    if args.mesh is not None:
        run_mesh(args.mesh, args.device)
        return
    if args.ranks is not None:
        run_ranks(args.ranks, args.device)
        return
    if not checks(resolve_device(args.device)):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

"""The LM stack's data and pipe axes over ranks, one process a rank, on the
CPU.

tests/test_torch_lm_ranks.py starts WORLD processes of

    PYTHONPATH=src:tests python tests/lm_ranks_check.py RANK WORLD STORE OUT INPUTS

Each joins a gloo group through a ``FileStore`` in STORE, makes the
subgroups of the first 1, 2 and 4 ranks, and runs the cases below on
them; rank 0 writes each case's results (a rank's own block gathered over
the axis) into OUT as ``<case>.pt``. The test runs the same functions
stacked in one process and holds the two bit for bit. INPUTS is the file
the test writes (`torch.save`): each config's initial train state, the
reference's, and its batches. No JAX here.

Cases:

- `reductions` over 1, 2, 4 and 8 ranks: the int8 error-feedback
  reduction and the exact mean of 8 shards, float32 and bfloat16
  gradients, 3 rounds carrying the residuals; and check C's 60 steps
  (examples/torch_dist_lm.py), both reductions;
- `pipeline` over 2 and 4 ranks: check B's GPipe (4 stages, 8
  microbatches) and one with fewer microbatches than stages, the output
  and the stage gradients for one cotangent, and each rank's count of
  exchanges run backwards;
- `train` over 2 and 4 ranks: 3 data-parallel steps of each config
  (`port_configs`), one shard a rank, the gradients gathered
  `CHUNK_BYTES` at a time (so that a leaf crosses in several chunks);
  over 2 ranks also with 2 microbatches a rank; each rank writes its own
  final state and metrics (``train.<config>.<world>.<k>.rank<r>.pt``);
- `supervised` over 2 ranks: `Supervisor` with a `CheckpointManager` over
  the ranks, saves every 2 steps, and a `FailureInjector` on rank 1 alone
  failing step 3: every rank restores step 2; each rank's writes counted;
  and the same run with no failure;
- `step_failure` over 2 ranks (a group with a 5 s timeout): a failure
  raised inside rank 1's step is not recovered: rank 1 raises it, and
  rank 0 ends with the group's error instead of waiting for ever.
"""

from __future__ import annotations

import datetime
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
REDUCE_WORLDS = (1, 2, 4, 8)
WORLDS = (2, 4)
SHARDS = 8
ROUNDS = 3
LEAVES = {"w": (33, 17), "b": (5,)}
STEPS = 3
SUPERVISED = dict(steps=6, save_every=2, fail_at=3, fail_rank=1, world=2)
STEP_FAILURE = dict(at=1, timeout_s=5)
CHUNK_BYTES = 16384
DENSE_ARCH = "phi3-mini-3.8b"


def example():
    """examples/torch_dist_lm.py as a module (checks B and C)."""
    spec = importlib.util.spec_from_file_location("torch_dist_lm", ROOT / "examples" / "torch_dist_lm.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    return ex


def port_configs() -> dict:
    """The two configs: check A's ``tiny_moe`` (tests/dist_lm_check.py) and
    the smoke config of `DENSE_ARCH`."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import LayerSpec, ModelConfig, MoEConfig

    tiny_moe = ModelConfig(name="tiny_moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                           pattern=(LayerSpec("attn", "moe"),),
                           moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=4.0))
    return {"tiny_moe": tiny_moe, "dense": get_smoke_config(DENSE_ARCH)}


def train_config(microbatches: int = 1):
    """Check A's optimizer and schedule."""
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import TrainConfig

    return TrainConfig(optimizer=AdamWConfig(lr=1e-3), schedule=ScheduleConfig(warmup_steps=2, total_steps=50),
                       microbatches=microbatches)


def clone_tree(tree):
    from repro_torch.tree import tree_map

    return tree_map(torch.clone, tree)


def shard(batch: dict, r: int, world: int) -> dict:
    """Rank ``r``'s rows of a global batch (`data.shard_batch_at`'s)."""
    per = next(iter(batch.values())).shape[0] // world
    return {k: v[r * per:(r + 1) * per] for k, v in batch.items()}


# -- the cases (``ranks`` None: the stacked run in one process) -------------------------------


def reduction_inputs():
    """Per dtype: ROUNDS rounds of stacked gradients, and the first
    residuals (float32), from a numpy seed."""
    rng = np.random.default_rng(28)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        grads = [{k: torch.from_numpy(rng.normal(size=(SHARDS, *s)).astype(np.float32)).to(dt) for k, s in
                  LEAVES.items()} for _ in range(ROUNDS)]
        res = {k: torch.from_numpy(rng.normal(size=(SHARDS, *s)).astype(np.float32) * 1e-2) for k, s in LEAVES.items()}
        out[str(dt)] = (grads, res)
    return out


def reductions(ranks) -> dict:
    """Both reductions over ROUNDS rounds, and check C's runs; residuals
    gathered over the data axis."""
    from repro_torch.distributed.compression import compressed_psum_grads, exact_pmean_grads

    block = (lambda t: t) if ranks is None else ranks.block
    full = (lambda t: t) if ranks is None else ranks.gather
    out = {}
    for dt, (grads, res) in reduction_inputs().items():
        res = {k: block(v).clone() for k, v in res.items()}
        for i, g in enumerate(grads):
            g = {k: block(v) for k, v in g.items()}
            mean, res = compressed_psum_grads(g, res, ranks)
            exact = exact_pmean_grads(g, ranks)
            for k in LEAVES:
                out[f"{dt}.{i}.mean.{k}"] = mean[k]
                out[f"{dt}.{i}.exact.{k}"] = exact[k]
                out[f"{dt}.{i}.res.{k}"] = full(res[k])
    ex = example()
    for c in (False, True):
        losses, w, res = ex.dp_train(c, "cpu", ranks=ranks)
        out[f"check_c.{c}.losses"] = torch.tensor(losses, dtype=torch.float64)
        out[f"check_c.{c}.w"] = w
        out[f"check_c.{c}.res"] = full(res)
    return out


def pipeline_cases():
    """(name, stage weights (S, D, D), microbatches (M, mb, D), cotangent)."""
    ex = example()
    w, x = (torch.from_numpy(a) for a in ex.pipeline_inputs())
    rng = np.random.default_rng(29)
    out = []
    for name, xs in (("check_b", x), ("short", x[:2])):
        out.append((name, w, xs, torch.from_numpy(rng.normal(size=tuple(xs.shape)).astype(np.float32))))
    return out


def pipeline(ranks) -> dict:
    """GPipe forward and stage gradients (gathered over the pipe axis);
    over ranks, each rank's exchanges run backwards."""
    from repro_torch.distributed.pipeline import pipeline_forward

    ex = example()
    out = {}
    for name, w, x, cot in pipeline_cases():
        stages = (w if ranks is None else ranks.block(w)).clone().requires_grad_(True)
        before = 0 if ranks is None else ranks.counts["shift_backward"]
        y = pipeline_forward(stages, x, ex.tanh_stage, mesh={"pipe": w.shape[0]}, ranks=ranks)
        (g,) = torch.autograd.grad(y, stages, cot)
        out[f"{name}.out"] = y.detach()
        out[f"{name}.grad"] = g if ranks is None else ranks.gather(g)
        if ranks is not None:
            n = torch.tensor(ranks.counts["shift_backward"] - before, dtype=torch.int64)
            out[f"{name}.backwards"] = ranks.values(n)
    return out


def train(state, batches, cfg, ranks, k: int = 1):
    """STEPS steps from ``state`` (a copy): over ranks, each on this rank's
    shard; stacked, at ``microbatches = k``. Returns (state, metrics)."""
    from repro_torch.train import make_train_step

    step = make_train_step(cfg, train_config(k), ranks)
    state = clone_tree(state)
    metrics = []
    for b in batches[:STEPS]:
        state, m = step(state, b if ranks is None else shard(b, ranks.rank, ranks.world))
        metrics.append({name: v.clone() for name, v in m.items()})
    return state, metrics


def supervised(state, batches, cfg, ranks, ckpt_dir: str, fail: bool):
    """SUPERVISED's run through the `Supervisor` (a failure at its step on
    one rank, or none); returns (state, steps run, restarts, writes this
    rank made)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import FailureInjector, Supervisor
    from repro_torch.train import make_train_step

    step = make_train_step(cfg, train_config(), ranks)
    mgr = CheckpointManager(ckpt_dir, keep=5, ranks=ranks)
    writes = [0]
    write = mgr._write

    def counted(*args):
        writes[0] += 1
        return write(*args)

    mgr._write = counted
    injector = FailureInjector((SUPERVISED["fail_at"],)) if fail and ranks.rank == SUPERVISED["fail_rank"] else None
    sup = Supervisor(lambda st, i: step(st, shard(batches[i], ranks.rank, ranks.world)), mgr,
                     save_every=SUPERVISED["save_every"], injector=injector, ranks=ranks)
    state, last = sup.run(clone_tree(state), SUPERVISED["steps"])
    return state, [m["step"] for m in sup.metrics_log], sup.restarts, writes[0], last


def step_failure(state, batches, cfg, ranks, ckpt_dir: str) -> dict:
    """A failure raised inside rank 1's step (not an injected one) under
    the `Supervisor` over 2 ranks whose group times out after
    ``STEP_FAILURE["timeout_s"]``: rank 1 raises it, rank 0 ends with the
    group's error. Returns what each rank raised and after how long."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import Supervisor
    from repro_torch.train import make_train_step

    step = make_train_step(cfg, train_config(), ranks)

    def step_fn(st, i):
        if ranks.rank == 1 and i == STEP_FAILURE["at"]:
            raise RuntimeError(f"a failure inside rank 1's step {i}")
        return step(st, shard(batches[i], ranks.rank, ranks.world))

    sup = Supervisor(step_fn, CheckpointManager(ckpt_dir, ranks=ranks), save_every=1, ranks=ranks)
    t0 = time.monotonic()
    try:
        sup.run(clone_tree(state), STEP_FAILURE["at"] + 2)
        raised = None
    except RuntimeError as exc:
        raised = f"{type(exc).__name__}: {exc}"
    return {"raised": raised, "seconds": time.monotonic() - t0, "restarts": sup.restarts}


# -- one rank -------------------------------------------------------------------------------


def main(rank: int, world: int, store: str, out_dir: str, inputs: str) -> None:
    import torch.distributed as dist

    import repro_torch.distributed.ranks as ranks_module
    from repro_torch.distributed.ranks import AxisRanks, close_ranks, init_ranks

    torch.set_num_threads(1)
    # small chunks, so that a leaf of these small models crosses in several
    ranks_module.GATHER_CHUNK_BYTES = CHUNK_BYTES
    init_ranks(rank, world, store, device="cpu", timeout_s=120.0)
    # every rank makes every group, members or not
    groups = {n: dist.new_group(list(range(n))) for n in REDUCE_WORLDS if n < world}
    groups[world] = dist.group.WORLD
    failing = dist.new_group([0, 1], timeout=datetime.timedelta(seconds=STEP_FAILURE["timeout_s"]))
    out = Path(out_dir)
    for n in REDUCE_WORLDS:
        if rank < n:
            got = reductions(AxisRanks.of_group("data", SHARDS, groups[n]))
            if rank == 0:
                torch.save(got, out / f"reductions.{n}.pt")
    if rank < max(WORLDS):
        data = torch.load(inputs, weights_only=True)
        cfgs = port_configs()
        for n in WORLDS:
            if rank >= n:
                continue
            got = pipeline(AxisRanks.of_group("pipe", 4, groups[n]))
            if rank == 0:
                torch.save(got, out / f"pipeline.{n}.pt")
            for name, cfg in cfgs.items():
                for k in (1, 2) if n == 2 else (1,):
                    ranks = AxisRanks.of_group("data", n, groups[n])
                    state, metrics = train(data[name]["state"], data[name]["batches"], cfg, ranks, k)
                    torch.save({"state": state, "metrics": metrics, "counts": dict(ranks.counts)},
                               out / f"train.{name}.{n}.{k}.rank{rank}.pt")
        n = SUPERVISED["world"]
        if rank < n:
            ranks = AxisRanks.of_group("data", n, groups[n])
            name = "tiny_moe"
            for fail in (True, False):
                state, steps, restarts, writes, last = supervised(
                    data[name]["state"], data[name]["batches"], cfgs[name], ranks,
                    str(out / f"ckpt.{'fail' if fail else 'straight'}"), fail)
                torch.save({"state": state, "steps": steps, "restarts": restarts, "writes": writes, "last": last},
                           out / f"supervised.{fail}.rank{rank}.pt")
    if rank < 2:
        data = torch.load(inputs, weights_only=True)
        got = step_failure(data["tiny_moe"]["state"], data["tiny_moe"]["batches"], port_configs()["tiny_moe"],
                           AxisRanks.of_group("data", 2, failing), str(out / "ckpt.step_failure"))
        torch.save(got, out / f"step_failure.rank{rank}.pt")
    close_ranks()
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])

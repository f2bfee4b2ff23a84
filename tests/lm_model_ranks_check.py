"""The LM stack's model axis over ranks (tensor and vocabulary parallelism),
one process a rank, on the CPU.

tests/test_torch_lm_model_ranks.py starts WORLD processes of

    PYTHONPATH=src:tests python tests/lm_model_ranks_check.py RANK WORLD STORE OUT INPUTS

Each joins a gloo group through a ``FileStore`` in STORE, with one thread,
lays out the (data, model) meshes of `MESHES` over its ranks (every rank
makes every group, member or not), and runs the cases below; the rank of
model rank 0 in each data row writes its results into OUT as ``<case>.pt``,
with every tree gathered whole over the model ranks. INPUTS is the file
the test writes (`torch.save`): each config's initial train state, whole,
and its batches. No JAX here.

Cases:

- `train`: STEPS steps of each config of `CONFIGS` over each mesh of
  `MESHES` (and of `ONE_MESH` over 1x2), from the whole initial state cut
  to the rank's blocks, each rank on its data shard: the gathered state,
  the metrics and the model axis's collectives counted;
- `checkpoint`: the 1x2 run of `REF_ARCH` saves its last step through a
  `CheckpointManager` over the layout (rank 0 writes the whole tree);
- `m1`: `REF_ARCH` over a 2x1 layout (the model path over groups of one)
  and over the data axis alone on the same 2 ranks;
- `supervised`: `REF_ARCH` over 2x2 through the `Supervisor`, saves every
  `SUPERVISED["save_every"]` steps, a `FailureInjector` on rank 1 alone
  failing step `SUPERVISED["fail_at"]`: every rank restores and replays;
  and the same run with no failure;
- `launch`: `launch.train.train` of `LAUNCH_ARGV` over the 2x2 layout; rank
  0 writes its lines and losses.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

WORLD = 4
STEPS = 3
BATCH, SEQ = 4, 16
# name -> (D, M, the global ranks of the layout)
MESHES = {"1x2": (1, 2, (0, 1)), "2x2": (2, 2, (0, 1, 2, 3)), "1x4": (1, 4, (0, 1, 2, 3))}
CONFIGS = ("phi3-mini-3.8b", "starcoder2-7b", "gemma3-27b")
ONE_MESH = ("whisper-tiny", "llava-next-mistral-7b")
REF_ARCH = "phi3-mini-3.8b"
SUPERVISED = dict(steps=STEPS + 1, save_every=2, fail_at=3, fail_rank=1)
LAUNCH_ONE = ["--arch", REF_ARCH, "--smoke", "--steps", "3", "--global-batch", "4", "--seq", "16", "--device", "cpu"]
LAUNCH_ARGV = LAUNCH_ONE + ["--mesh", "2x2", "--ranks", "4"]


def train_config(microbatches: int = 1):
    """Check A's optimizer and schedule."""
    from repro_torch.optim import AdamWConfig, ScheduleConfig
    from repro_torch.train import TrainConfig

    return TrainConfig(optimizer=AdamWConfig(lr=1e-3), schedule=ScheduleConfig(warmup_steps=2, total_steps=50),
                       microbatches=microbatches)


def make_inputs(arch: str, state=None, cfg=None) -> dict:
    """``arch``'s smoke config's (or ``cfg``'s) whole initial train state
    (``state``, or the port's own from seed 0) and STEPS + 1 batches of
    BATCH x SEQ tokens, with the stub frames (whisper) and prefix
    embeddings (llava) from a numpy seed."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data import DataConfig, global_batch_at
    from repro_torch.train import init_train_state

    cfg = cfg or get_smoke_config(arch)
    if state is None:
        state = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(30)
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=BATCH, seq_len=SEQ, seed=0)
    batches = []
    for i in range(STEPS + 1):
        b = global_batch_at(i, data, device="cpu")
        if cfg.encoder_layers:
            b["frames"] = torch.from_numpy(rng.normal(size=(BATCH, cfg.encoder_frames, cfg.d_model)).astype(np.float32))
        if cfg.prefix_tokens:
            b["prefix_embeddings"] = torch.from_numpy(
                rng.normal(size=(BATCH, cfg.prefix_tokens, cfg.d_model)).astype(np.float32))
        batches.append(b)
    return {"state": state, "batches": batches}


def clone_tree(tree):
    from repro_torch.tree import tree_map

    return tree_map(torch.clone, tree)


def shard(batch: dict, r: int, world: int) -> dict:
    """Data shard ``r``'s rows of a global batch (`data.shard_batch_at`'s)."""
    per = next(iter(batch.values())).shape[0] // world
    return {k: v[r * per:(r + 1) * per] for k, v in batch.items()}


def train(arch: str, inputs: dict, ranks, k: int = 1, cfg=None):
    """STEPS steps of ``arch``'s smoke config (or ``cfg``) from the whole
    initial state: over ``ranks`` (a `MeshRanks` layout or a data
    `AxisRanks`) on this rank's blocks and data shard; with None the
    one-process step at ``microbatches = k``. Returns (the state, whole;
    the metrics; the model axis's step counts; the state of blocks; the
    step)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.ranks import MeshRanks
    from repro_torch.train import make_train_step
    from repro_torch.train.step import state_blocks

    cfg = cfg or get_smoke_config(arch)
    step = make_train_step(cfg, train_config(k), ranks)
    blocks = state_blocks(cfg, step.rules) if isinstance(ranks, MeshRanks) else None
    data = None if ranks is None else (ranks.data if blocks is not None else ranks)
    state = clone_tree(inputs["state"]) if blocks is None else blocks.cut(inputs["state"])
    metrics = []
    for b in inputs["batches"][:STEPS]:
        state, m = step(state, b if data is None else shard(b, data.rank, data.world))
        metrics.append({name: v.clone() for name, v in m.items()})
    whole = state if blocks is None else blocks.gather(state)
    counts = {} if blocks is None else dict(step.rules.model.counts)
    return whole, metrics, counts, state, step


def supervised(inputs: dict, ranks, ckpt_dir: str, fail: bool):
    """`SUPERVISED`'s run of `REF_ARCH` over ``ranks`` through the
    `Supervisor`, with a failure on one rank or none; returns (the whole
    state, steps run, restarts)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.fault import FailureInjector, Supervisor
    from repro_torch.train import make_train_step
    from repro_torch.train.step import state_blocks

    cfg = get_smoke_config(REF_ARCH)
    step = make_train_step(cfg, train_config(), ranks)
    blocks = state_blocks(cfg, step.rules)
    mgr = CheckpointManager(ckpt_dir, keep=5, ranks=ranks, blocks=blocks)
    injector = FailureInjector((SUPERVISED["fail_at"],)) if fail and ranks.rank == SUPERVISED["fail_rank"] else None
    sup = Supervisor(lambda st, i: step(st, shard(inputs["batches"][i], ranks.data.rank, ranks.data.world)), mgr,
                     save_every=SUPERVISED["save_every"], injector=injector, ranks=ranks)
    state, _ = sup.run(blocks.cut(inputs["state"]), SUPERVISED["steps"])
    return blocks.gather(state), [m["step"] for m in sup.metrics_log], sup.restarts


# -- one rank -------------------------------------------------------------------------------


def main(rank: int, world: int, store: str, out_dir: str, inputs_path: str) -> None:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.ranks import close_ranks, init_ranks, mesh_ranks
    from repro_torch.launch import train as launch_train
    from repro_torch.train.step import state_blocks

    torch.set_num_threads(1)
    init_ranks(rank, world, store, device="cpu", timeout_s=120.0)
    # every rank makes every group, in one order
    layouts = {name: mesh_ranks(d, m, members) for name, (d, m, members) in MESHES.items()}
    m1 = mesh_ranks(2, 1, (0, 1))
    out = Path(out_dir)
    inputs = torch.load(inputs_path, weights_only=True)

    def write(name, lay, value):
        if lay.model.rank == 0:
            torch.save(value, out / f"{name}.row{lay.data.rank}.pt")

    for arch in CONFIGS + ONE_MESH:
        for name, lay in layouts.items():
            if lay is None or (arch in ONE_MESH and name != "1x2"):
                continue
            whole, metrics, counts, state, step = train(arch, inputs[arch], lay)
            write(f"train.{arch}.{name}", lay, {"state": whole, "metrics": metrics, "counts": counts})
            if arch == REF_ARCH and name == "1x2":
                mgr = CheckpointManager(str(out / "ckpt.1x2"), ranks=lay,
                                        blocks=state_blocks(get_smoke_config(arch), step.rules))
                mgr.save(STEPS, state)
    if m1 is not None:
        for name, ranks in (("mesh", m1), ("data", m1.data)):
            whole, metrics, *_ = train(REF_ARCH, inputs[REF_ARCH], ranks)
            write(f"m1.{name}", m1, {"state": whole, "metrics": metrics})
    lay = layouts["2x2"]
    for fail in (True, False):
        whole, steps, restarts = supervised(inputs[REF_ARCH], lay, str(out / f"ckpt.supervised.{fail}"), fail)
        every = lay.values(torch.tensor(restarts, dtype=torch.int64)).tolist()
        write(f"supervised.{fail}", lay, {"state": whole, "steps": steps, "restarts": every})
    lines = []
    args = launch_train.parser().parse_args(LAUNCH_ARGV + ["--ckpt-dir", str(out / "ckpt.launch")])
    losses = launch_train.train(args, lay, torch.device("cpu"), out=lines.append)
    if rank == 0:
        torch.save({"lines": lines, "losses": losses}, out / "launch.pt")
    close_ranks()
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])

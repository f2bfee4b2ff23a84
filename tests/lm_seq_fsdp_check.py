"""Sequence parallelism and the ``fsdp`` rule over ranks, one process a
rank, on the CPU.

tests/test_torch_lm_seq_fsdp.py starts WORLD processes of

    PYTHONPATH=src:tests python tests/lm_seq_fsdp_check.py RANK WORLD STORE OUT INPUTS

Each joins a gloo group through a ``FileStore`` in STORE, with one thread,
lays out the (data, model) meshes of `MESHES` over its ranks (every rank
makes every group, member or not), and runs the cases below on check A's
``tiny_moe`` (tests/dist_lm_check.py: 2 layers, d 32, 4 experts top-2),
whose rule table (`rules_for`) puts the sequence on ``model`` and
``fsdp`` on ``data``. Trees are gathered whole over both axes; the rank
``(0, 0)`` of a layout writes them into OUT as ``<case>.pt``. INPUTS is
the file the test writes (`torch.save`) once the ranks have started,
which they wait for: the reference's initial train
state and its batches, as tensors, and ``one_head``'s (the port's own
initial state). No JAX here.

Cases:

- `train`: STEPS steps over each mesh of `MESHES` (from the whole state
  cut to the rank's blocks, each data rank on its shard): the gathered
  state, the metrics, each axis's collectives counted, every rank's leaf
  shapes and every model rank's norm scales as it holds them; over 2x2
  the state after `SAVE_AT` steps is saved (`CheckpointManager` over the
  layout, which gathers a larger leaf a few of its periods or columns at a
  time);
- `mutation`: 1x2 with the norm scales' gradients left unsummed over the
  model ranks (`TensorParallel.copy_in` passes them through);
- `one_head`: ``config(1)`` over 1x2, its attention whole on both ranks;
- `data`: the data axis alone (PR 28's data-parallel step) on the 2 ranks
  of the 2x1 layout;
- `resume`: the 2x2 save restored over 2x2 and over 1x1 (rank 0), and one
  step more from it;
- `launch`: `launch.train.train` over 2x2, ``tiny_moe`` in the place of
  the smoke config; rank 0 writes its lines and losses;
- `uneven`: the data group's two collectives (`AxisRanks.gather_dim`,
  `AxisRanks.reduce_scatter`) over the 3 ranks of 1x3's model group, on
  axes of 7 and 4 entries (blocks of 3, 2, 2 and 2, 1, 1), the
  reduce-scatter a row of the leading dimension at a time; each rank
  writes what it got.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

WORLD = 4
STEPS = 3
SAVE_AT = 2
BATCH, SEQ = 8, 32          # check A's batch; 32 positions over 3 model ranks: blocks of 11, 11 and 10
# name -> (D, M, the global ranks of the layout); 2x1 runs on ranks 2 and 3 while 1x2 runs on 0 and 1, and 1x1
# on rank 3 while 1x3 runs on the others
MESHES = {"2x2": (2, 2, (0, 1, 2, 3)), "1x2": (1, 2, (0, 1)), "2x1": (2, 1, (2, 3)), "1x3": (1, 3, (0, 1, 2)),
          "1x1": (1, 1, (3,))}
LAUNCH_ONE = ["--arch", "deepseek-moe-16b", "--smoke", "--steps", str(STEPS), "--global-batch", str(BATCH), "--seq",
              str(SEQ), "--device", "cpu"]
LAUNCH_ARGV = LAUNCH_ONE + ["--mesh", "2x2", "--ranks", "4"]


def config(heads: int = 4):
    """Check A's ``tiny_moe``; with ``heads=1`` one head, which `rules_for`
    leaves whole over 2 model ranks: the attention then runs on every
    rank over the gathered sequence (`TensorParallel.seq_share`)."""
    from repro_torch.models import LayerSpec, ModelConfig, MoEConfig

    return ModelConfig(name="tiny_moe", n_layers=2, d_model=32, n_heads=heads, n_kv_heads=min(heads, 2), d_ff=64,
                       vocab_size=64, pattern=(LayerSpec("attn", "moe"),),
                       moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=4.0))


def launch_args(argv):
    """``launch.train``'s arguments for ``argv`` with ``tiny_moe`` as the
    config the launcher builds (its parser takes only registered archs)."""
    from repro_torch.launch import train as launch_train

    launch_train.get_smoke_config = lambda arch: config()
    return launch_train.parser().parse_args(argv)


def run(inputs: dict, ranks, k: int = 1, *, state=None, first: int = 0, steps: int = STEPS, save=None, cfg=None):
    """``steps`` steps from batch ``first`` of ``inputs`` and from
    ``state`` (whole; default the initial state): over ``ranks`` (a
    `MeshRanks` layout or a data `AxisRanks`) on this rank's blocks and
    data shard, with None the one-process step at ``microbatches = k``.
    ``save``: a directory the state after `SAVE_AT` steps is saved in;
    ``cfg``: a config in place of `config()`. Returns (the state, whole;
    the metrics; the state of blocks; the step)."""
    import lm_model_ranks_check as base
    import repro_torch.distributed.ranks as ranks_mod
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.ranks import MeshRanks
    from repro_torch.train import make_train_step
    from repro_torch.train.step import state_blocks

    cfg = cfg or config()
    step = make_train_step(cfg, base.train_config(k), ranks)
    blocks = state_blocks(cfg, step.rules) if isinstance(ranks, MeshRanks) else None
    data = None if ranks is None else (ranks.data if blocks is not None else ranks)
    whole = inputs["state"] if state is None else state
    state = base.clone_tree(whole) if blocks is None else blocks.cut(whole)
    metrics = []
    for i in range(first, first + steps):
        b = inputs["batches"][i]
        state, m = step(state, b if data is None else base.shard(b, data.rank, data.world))
        metrics.append({name: v.clone() for name, v in m.items()})
        if save is not None and i + 1 == SAVE_AT:  # the larger cut leaves cross in several chunks
            keep, ranks_mod.GATHER_CHUNK_BYTES = ranks_mod.GATHER_CHUNK_BYTES, 4096
            try:
                CheckpointManager(save, ranks=ranks, blocks=blocks).save(SAVE_AT, state)
            finally:
                ranks_mod.GATHER_CHUNK_BYTES = keep
    return (state if blocks is None else blocks.gather(state)), metrics, state, step


def restore(path: str, ranks):
    """The whole state of the checkpoint under ``path``, restored through a
    `CheckpointManager` over ``ranks`` (a layout: each rank reads its
    blocks, gathered whole here) or in one process (None)."""
    import lm_model_ranks_check as base
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.step import state_blocks

    rules = None if ranks is None else make_train_step(config(), base.train_config(), ranks).rules
    state = init_train_state(torch.Generator().manual_seed(1), config(), device="cpu", rules=rules)
    blocks = None if ranks is None else state_blocks(config(), rules)
    state, _ = CheckpointManager(path, ranks=ranks, blocks=blocks).restore(state)
    return state if blocks is None else blocks.gather(state)


def uneven_inputs():
    """`uneven`'s whole tensor and each of the 3 ranks' contributions, from
    a seed: the same on every rank."""
    gen = torch.Generator().manual_seed(32)
    return torch.randn(4, 7, 5, generator=gen), [torch.randn(4, 7, 5, generator=gen) for _ in range(3)]


def uneven(ax) -> dict:
    """`uneven`'s collectives on the `AxisRanks` ``ax`` of 3 ranks."""
    import repro_torch.distributed.ranks as ranks_mod
    from repro_torch.distributed.ranks import block_range

    whole, contrib = uneven_inputs()
    lo, hi = block_range(7, 3, ax.rank)
    got = {"gather": ax.gather_dim(whole[:, lo:hi], 1, 7)}
    keep = ranks_mod.GATHER_CHUNK_BYTES
    ranks_mod.GATHER_CHUNK_BYTES = contrib[0][0].numel() * 4
    try:
        got["scatter1"] = ax.reduce_scatter(contrib[ax.rank], 1, 7)
        got["scatter0"] = ax.reduce_scatter(contrib[ax.rank], 0, 4)
    finally:
        ranks_mod.GATHER_CHUNK_BYTES = keep
    got["chunks"] = ax.counts["reduce_scatter"]
    return got


# -- one rank -------------------------------------------------------------------------------


def main(rank: int, world: int, store: str, out_dir: str, inputs_path: str) -> None:
    from repro_torch.checkpoint import _flatten_with_names
    from repro_torch.distributed.ranks import close_ranks, init_ranks, mesh_ranks
    from repro_torch.distributed.tensor_parallel import TensorParallel
    from repro_torch.launch import train as launch_train

    torch.set_num_threads(1)
    init_ranks(rank, world, store, device="cpu", timeout_s=120.0)
    # every rank makes every group, in one order
    layouts = {name: mesh_ranks(d, m, members) for name, (d, m, members) in MESHES.items()}
    out = Path(out_dir)
    deadline = time.monotonic() + 60.0
    while not Path(inputs_path).exists():  # the test writes it while the ranks start
        if time.monotonic() > deadline:
            raise TimeoutError(f"no inputs at {inputs_path}")
        time.sleep(0.05)
    inputs = torch.load(inputs_path, weights_only=True)

    def write(name, lay, value):
        if lay.rank == 0:
            torch.save(value, out / f"{name}.pt")

    if layouts["1x3"] is not None:
        torch.save(uneven(layouts["1x3"].model), out / f"uneven.r{rank}.pt")
    for name, lay in layouts.items():
        if lay is None:
            continue
        save = str(out / "ckpt.2x2") if name == "2x2" else None
        whole, metrics, state, step = run(inputs, lay, save=save)
        counts = {"model": dict(step.rules.model.counts), "data": dict(step.rules.data.counts)}
        write(f"train.{name}", lay, {"state": whole, "metrics": metrics, "counts": counts})
        # what each rank holds: its leaves' shapes, and the norm scales (whole on every model rank)
        torch.save({"shapes": {n: tuple(t.shape) for n, t in _flatten_with_names(state)},
                    "scales": {n: t.clone() for n, t in _flatten_with_names(state["params"]) if "norm" in n}},
                   out / f"held.{name}.d{lay.data.rank}m{lay.model.rank}.pt")
        if name == "1x2":  # the mutation: the norm scales' gradients left unsummed over the model ranks
            keep = TensorParallel.copy_in
            TensorParallel.copy_in = lambda self, x, name="copy_in": x if name == "norm_scale" else keep(self, x, name)
            try:
                whole, metrics, *_ = run(inputs, lay)
            finally:
                TensorParallel.copy_in = keep
            write("mutation.1x2", lay, {"state": whole, "metrics": metrics})
        if name == "1x2":  # one head, whole on both model ranks
            whole, metrics, _, step = run(inputs["one_head"], lay, cfg=config(1))
            write("one_head.1x2", lay, {"state": whole, "metrics": metrics, "counts": dict(step.rules.model.counts)})
        if name == "2x1":  # PR 28's data-parallel step on the same ranks
            whole, metrics, *_ = run(inputs, lay.data)
            write("data.2x1", lay, {"state": whole, "metrics": metrics})
    lay = layouts["2x2"]
    for name in ("2x2", "1x1"):
        if layouts[name] is None:
            continue
        start = restore(str(out / "ckpt.2x2"), layouts[name])
        whole, metrics, *_ = run(inputs, layouts[name], state=start, first=SAVE_AT, steps=STEPS - SAVE_AT)
        write(f"resume.{name}", layouts[name], {"start": start, "state": whole, "metrics": metrics})
    lines = []
    args = launch_args(LAUNCH_ARGV + ["--ckpt-dir", str(out / "ckpt.launch")])
    losses = launch_train.train(args, lay, torch.device("cpu"), out=lines.append)
    if rank == 0:
        torch.save({"lines": lines, "losses": losses}, out / "launch.pt")
    close_ranks()
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])

"""The LM stack's model axis over ranks for MoE layers (expert parallelism,
and tensor parallelism inside each expert), one process a rank, on the CPU.

tests/test_torch_lm_expert_ranks.py starts WORLD processes of

    PYTHONPATH=src:tests python tests/lm_expert_ranks_check.py RANK WORLD STORE OUT INPUTS

Each joins a gloo group through a ``FileStore`` in STORE, with one thread,
lays out the (data, model) meshes of `MESHES` over its ranks (every rank
makes every group, member or not), and runs the cases below; the rank of
model rank 0 in each data row writes its results into OUT as ``<case>.pt``,
with every tree gathered whole over the model ranks. INPUTS is the file
the test writes (`torch.save`): each config's initial train state, whole,
and its batches. No JAX here.

Cases:

- `train`: STEPS steps of each config of `CASES` over its meshes, from the
  whole initial state cut to the rank's blocks, each rank on its data
  shard: the gathered state, the metrics and the model axis's
  collectives counted, and each model rank's replicated leaves as it holds
  them. `rules_for` puts the experts on ``model`` where M divides their
  count (1x2, 2x2), else every expert's width (1x3);
- `checkpoint`: the 1x2 run of `REF_ARCH` saves its last step through a
  `CheckpointManager` over the layout (rank 0 writes the whole tree);
- `m1`: `REF_ARCH` over a 2x1 layout (the model path over groups of one)
  and over the data axis alone on the same 2 ranks;
- `lone`: each config of `ONE_RANK` over a 1x1 layout on rank 0;
- `launch`: `launch.train.train` of each config of `LAUNCH` over the 1x2
  layout; rank 0 writes its lines and losses.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

import lm_model_ranks_check as base

WORLD = 4
STEPS = base.STEPS
# name -> (D, M, the global ranks of the layout)
MESHES = {"1x2": (1, 2, (0, 1)), "2x2": (2, 2, (0, 1, 2, 3)), "1x3": (1, 3, (0, 1, 2))}
# config -> its meshes: experts over 1x2 and 2x2; 1x3 splits each expert's width (8 and 4 experts over 3)
CASES = {"tiny_moe": ("1x2", "2x2"), "deepseek-moe-16b": ("1x2", "2x2", "1x3"), "mixtral-8x22b": ("1x2", "1x3")}
REF_ARCHS = ("tiny_moe", "deepseek-moe-16b")   # also held to the reference's step
REF_ARCH = "deepseek-moe-16b"
LAUNCH = ("deepseek-moe-16b", "mixtral-8x22b")
ONE_RANK = ("deepseek-moe-16b", "mixtral-8x22b")   # over a 1x1 layout: the one-process step bit for bit


def config(arch: str):
    """``arch``'s smoke config, or ``tiny_moe`` of tests/dist_lm_check.py
    (check A's model: 2 layers, d 32, 4 experts top-2)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import LayerSpec, ModelConfig, MoEConfig

    if arch == "tiny_moe":
        return ModelConfig(name="tiny_moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                           pattern=(LayerSpec("attn", "moe"),), moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=4.0))
    return get_smoke_config(arch)


def make_inputs(arch: str) -> dict:
    return base.make_inputs(arch, cfg=config(arch))


def train(arch: str, inputs: dict, ranks, k: int = 1):
    """`lm_model_ranks_check.train` of ``arch``'s config."""
    return base.train(arch, inputs, ranks, k, cfg=config(arch))


def launch_argv(arch: str) -> list[str]:
    """``launch.train``'s one-process command line of ``arch``'s smoke config."""
    return ["--arch", arch, "--smoke", "--steps", str(STEPS), "--global-batch", str(base.BATCH), "--seq",
            str(base.SEQ), "--device", "cpu"]


# -- one rank -------------------------------------------------------------------------------


def main(rank: int, world: int, store: str, out_dir: str, inputs_path: str) -> None:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.ranks import close_ranks, init_ranks, mesh_ranks
    from repro_torch.launch import train as launch_train
    from repro_torch.train.step import state_blocks
    from repro_torch.tree import tree_leaves

    torch.set_num_threads(1)
    init_ranks(rank, world, store, device="cpu", timeout_s=120.0)
    # every rank makes every group, in one order
    layouts = {name: mesh_ranks(d, m, members) for name, (d, m, members) in MESHES.items()}
    m1 = mesh_ranks(2, 1, (0, 1))
    lone = mesh_ranks(1, 1, (0,))
    out = Path(out_dir)
    inputs = torch.load(inputs_path, weights_only=True)

    def write(name, lay, value):
        if lay.model.rank == 0:
            torch.save(value, out / f"{name}.row{lay.data.rank}.pt")

    for arch, meshes in CASES.items():
        for name in meshes:
            lay = layouts[name]
            if lay is None:
                continue
            whole, metrics, counts, state, step = train(arch, inputs[arch], lay)
            write(f"train.{arch}.{name}", lay, {"state": whole, "metrics": metrics, "counts": counts})
            # every model rank's replicated leaves (the router, the norms, their moments), as that rank holds them
            blocks = state_blocks(config(arch), step.rules)
            if lay.data.rank == 0:
                torch.save([t for t, d in zip(tree_leaves(state), blocks.dims, strict=True) if d is None],
                           out / f"replicated.{arch}.{name}.m{lay.model.rank}.pt")
            if arch == REF_ARCH and name == "1x2":
                CheckpointManager(str(out / "ckpt.1x2"), ranks=lay, blocks=blocks).save(STEPS, state)
    if m1 is not None:
        for name, ranks in (("mesh", m1), ("data", m1.data)):
            whole, metrics, *_ = train(REF_ARCH, inputs[REF_ARCH], ranks)
            write(f"m1.{name}", m1, {"state": whole, "metrics": metrics})
    if lone is not None:
        for arch in ONE_RANK:
            whole, metrics, *_ = train(arch, inputs[arch], lone)
            write(f"lone.{arch}", lone, {"state": whole, "metrics": metrics})
    lay = layouts["1x2"]
    if lay is not None:
        for arch in LAUNCH:
            lines = []
            argv = launch_argv(arch) + ["--mesh", "1x2", "--ranks", "2", "--ckpt-dir", str(out / f"ckpt.{arch}")]
            losses = launch_train.train(launch_train.parser().parse_args(argv), lay, torch.device("cpu"),
                                        out=lines.append)
            if rank == 0:
                torch.save({"lines": lines, "losses": losses}, out / f"launch.{arch}.pt")
    close_ranks()
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])

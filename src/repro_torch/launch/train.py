"""Training launcher: the supervised, checkpointed LM training loop on one
device, or over ranks along the data axis, or the data and model axes.
Counterpart of `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b --smoke --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b --global-batch 2 --seq 4096 --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b --smoke --mesh 2 --ranks 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b --smoke --mesh 2x2 --ranks 4 --device cpu

Runs on ``cuda`` unless ``--device cpu``; with no card and no ``--device
cpu`` it raises. ``--smoke`` takes the arch's reduced config (float32);
without it the published config in bfloat16, parameters made on the device
from seed 0, AdamW moments in float32. Batches come from the synthetic
pipeline (`repro_torch.data`). Prints the losses, then ms a step (the
median over the steps after the first), tokens/s, peak device memory and
the model's TFLOP/s, ``4 * forward_flops / step time`` (the reference's
train convention, `launch.flops`).

``--mesh DxM`` (or ``D``) installs the rule table of `rules_for` for a
(data, model) mesh of those sizes around the run, as the reference's
launcher does. Its axes are held on the one device, so the rules place
nothing and the step is the same function: the losses are those of the run
without ``--mesh``, bit for bit. The table's sharded entries are printed
before the summary.

``--ranks N`` with ``--mesh D`` or ``--mesh DxM`` spreads the mesh over N
processes, one a rank (`torch.multiprocessing`, a ``FileStore`` in a
temporary directory; NCCL with one card a rank, gloo with ``--device
cpu``), as a (data, model) layout of D x N/D ranks (`MeshRanks`, rank
``d M + m``) under `rules_for`'s table: N = D·M of a ``DxM`` mesh spreads
both axes, N = D the data axis alone (a model axis M then stays on each
rank's card, where its rules place nothing). Each rank holds its block
of every attention head, MLP width, vocabulary row and MoE expert (or
each expert's width) that the table places on ``model``, and in training
its block of the residual stream's sequence between the regions (tensor,
vocabulary, expert and sequence parallelism,
`distributed.tensor_parallel`); each data rank holds its slice of every
``fsdp`` dimension of the layer matrices and of their two AdamW moments
(`distributed.fsdp`), gathered whole inside each period's remat region,
and trains on its shard of each step's global batch
(`data.shard_batch_at`). The losses are those of the one-process run
with ``--microbatches D`` within rounding (the row-parallel contractions
add their partial sums in another order, and the gradient norm's squares
group by slice), and bit for bit at D = M = 1, where every collective
still runs over a group of one. Whisper's table puts the sequence
nowhere, and decode puts it nowhere either.

Rank 0 writes the checkpoints (the whole tree gathered a bounded chunk
at a time from every rank's blocks) and prints the lines, with the
gradient reduction's ms a step and its bytes a rank, and the model-axis
and the data-axis collectives' ms a step, bytes a rank a step and counts
a step. It refuses, by name and before it starts a process,
``--ranks`` without ``--mesh``, any other rank count, a model axis over
ranks (M > 1) for a config with Mamba or xLSTM layers (their model-axis
forms are not built), and more ranks than visible cards; nothing runs
fewer ranks, the CPU, or the model axis held on one card in their place.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import DataConfig, global_batch_at, shard_batch_at
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import Supervisor
from repro_torch.distributed.sharding import Rules, rules_for, use_rules
from repro_torch.launch.flops import forward_flops
from repro_torch.optim import AdamWConfig, ScheduleConfig
from repro_torch.train import StepClock, TrainConfig, init_train_state, make_train_step


def summary(cfg, losses: list[float], step_ms: list[float], batch: int, seq: int, device) -> str:
    """The run's line: losses, ms a step, tokens/s, peak memory, TFLOP/s."""
    steady = step_ms[1:] or step_ms
    ms = statistics.median(steady)
    tokens = batch * seq
    fwd = forward_flops(cfg, n_tokens=tokens, s_ctx=seq / 2, enc_tokens=batch * cfg.encoder_frames)
    tflops = 4.0 * fwd / (ms * 1e-3) / 1e12
    if device.type == "cuda":
        where = (f"{tflops:.2f} model TFLOP/s, peak {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB on "
                 f"{torch.cuda.get_device_name(device)}")
    else:
        where = "model TFLOP/s and peak memory not measured (cpu)"
    return (f"{cfg.name}: {len(losses)} steps, losses " + " ".join(f"{x:.4f}" for x in losses)
            + f"; {ms:.2f} ms/step (median of {len(steady)}), {tokens * 1e3 / ms:.1f} tokens/s, {where}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced (smoke) config, float32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default=None, help="a (data, model) mesh such as 2x2, or a data mesh such as 2")
    ap.add_argument("--ranks", type=int, default=None, metavar="N",
                    help="spread --mesh over N processes, one a rank: N = D spreads the data axis, N = D*M the data "
                         "and model axes")
    ap.add_argument("--device", default=None, help="cuda (default; must exist) or cpu")
    return ap


def mesh_shape(text: str) -> tuple[int, ...]:
    return tuple(int(x) for x in text.split("x"))


def train(args, ranks=None, device=None, out=print) -> list[float]:
    """The run of ``args`` on ``device``; over ``ranks`` (a `MeshRanks`
    layout of the data and model axes) this rank's part of it. ``out``
    prints the lines. Returns the losses."""
    from repro_torch.train.step import state_blocks

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch, dtype=torch.bfloat16)
    rules = None
    if args.mesh:
        shape = mesh_shape(args.mesh)
        table = rules_for(cfg, mode="train", multi_pod=False, data_axis=shape[0],
                          model_axis=shape[-1] if len(shape) > 1 else 1)
        rules = Rules(table, dict(zip(("data", "model")[:len(shape)], shape)))
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=args.global_batch, seq_len=args.seq)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=args.lr),
                       schedule=ScheduleConfig(warmup_steps=10, total_steps=args.steps),
                       microbatches=args.microbatches)

    step = make_train_step(cfg, tcfg, ranks)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(gen, cfg, device=device, rules=step.rules)
    clock = StepClock(device)
    timed = clock.wrap(step)

    def step_fn(st, i):
        if ranks is None:
            return timed(st, global_batch_at(i, data, device=device))
        return timed(st, shard_batch_at(i, data, ranks.data.rank, ranks.data.world, device=device))

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    blocks = None if ranks is None else state_blocks(cfg, step.rules)
    sup = Supervisor(step_fn, CheckpointManager(args.ckpt_dir, keep=3, ranks=ranks, blocks=blocks),
                     save_every=args.save_every, ranks=ranks)
    t0 = time.perf_counter()
    with use_rules(rules):
        sup.run(state, args.steps)
    losses = [float(m["loss"]) for m in sup.metrics_log]
    wall = time.perf_counter() - t0

    if rules is not None:
        out(f"mesh {rules.mesh}: rules " + ", ".join(f"{k}={v}" for k, v in rules.table.items() if v is not None))
    out(summary(cfg, losses, clock.ms(), args.global_batch, args.seq, device))
    where = "host clock, cpu" if device.type == "cpu" else f"CUDA events, {torch.cuda.get_device_name(device)}"
    if ranks is not None:
        red = step.reduction.ms()
        out(f"gradient reduction over {ranks.data.world} ranks: {statistics.median(red[1:] or red):.2f} ms/step "
            f"(median of {len(red[1:] or red)}, {where}), {step.reduce_bytes / 1e6:.3f} MB a rank (its "
            f"contribution, gathered by the other {ranks.data.world - 1})")
        tp = step.rules.model
        tms = tp.step_ms()
        out(f"model-axis collectives over {tp.world} ranks: {statistics.median(tms[1:] or tms):.2f} ms/step (median "
            f"of {len(tms[1:] or tms)}, {where}), {tp.sent / len(tms) / 1e6:.3f} MB a rank a step (its "
            f"contributions, all-gathered and summed in rank order); {sum(tp.counts.values()) // len(tms)} a step "
            f"({', '.join(f'{k} {v // len(tms)}' for k, v in sorted(tp.counts.items()))})")
        fs = step.rules.data
        if fs is not None:
            fms = fs.step_ms()
            out(f"data-axis collectives over {fs.world} ranks: {statistics.median(fms[1:] or fms):.2f} ms/step "
                f"(median of {len(fms[1:] or fms)}, {where}), {fs.sent / len(fms) / 1e9:.6f} GB a rank a step (the "
                f"fsdp slices gathered, forward and recompute, and their gradients reduce-scattered); "
                f"{sum(fs.counts.values()) // len(fms)} a step "
                f"({', '.join(f'{k} {v // len(fms)}' for k, v in sorted(fs.counts.items()))})")
    out(f"wall {wall:.1f} s for {len(losses)} steps and the checkpoint saves (every {args.save_every} steps and "
        f"at the last, to {args.ckpt_dir}); restarts {sup.restarts}")
    return losses


def layout(args) -> tuple[int, int, int]:
    """``(D, M, ranks)`` of ``args.mesh``: ``ranks`` is the model axis's
    ranks, M where ``--ranks`` is D·M of a ``DxM`` mesh, else 1 (the model
    axis held on each rank's card)."""
    shape = mesh_shape(args.mesh)
    d, m = shape[0], (shape[1] if len(shape) > 1 else 1)
    return d, m, (m if args.ranks == d * m else 1)


def run_ranks(args, device=None) -> None:
    """``args`` over ``args.ranks`` spawned processes, one a rank; checked
    first (`check_axis_request`); a rank that fails makes this raise."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.distributed.ranks import check_axis_request

    on_cpu = device is not None and torch.device(device).type == "cpu"
    n_cards = None if on_cpu else (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    d, _, model = layout(args)
    check_axis_request(args.ranks, d, n_cards=n_cards, axis="data", model=model)
    store = tempfile.mkdtemp(prefix="train_ranks_")
    try:
        mp.start_processes(_rank_main, args=(args.ranks, store, vars(args), "cpu" if on_cpu else None),
                           nprocs=args.ranks, start_method="spawn")
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _rank_main(rank: int, world: int, store: str, arg_dict: dict, device) -> None:
    """One rank of `run_ranks`: join the group, train on this rank's data
    shard and blocks; rank 0 prints."""
    import functools
    import os

    from repro_torch.distributed.ranks import close_ranks, init_ranks, mesh_ranks

    dev = init_ranks(rank, world, store, device=device)
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        args = argparse.Namespace(**arg_dict)
        d, _, model = layout(args)
        ranks = mesh_ranks(d, model)
        out = functools.partial(print, flush=True) if rank == 0 else (lambda *a, **k: None)
        train(args, ranks, dev, out)
    finally:
        close_ranks()


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    if args.ranks is not None:
        if not args.mesh:
            ap.error("--ranks spreads the data axis over processes: name it with --mesh D or --mesh DxM")
        d, m, model = layout(args)
        if args.ranks != d * model:
            ap.error(f"--ranks {args.ranks} must equal the data axis of --mesh {args.mesh} ({d}), or D·M ({d * m}) "
                     "with --mesh DxM to spread the model axis too")
        if model > 1:
            from repro_torch.distributed.tensor_parallel import check_model_axis

            cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch, dtype=torch.bfloat16)
            try:
                check_model_axis(cfg, model)
            except ValueError as exc:
                ap.error(f"--mesh {args.mesh} --ranks {args.ranks}: {exc}")
        if args.global_batch % (d * args.microbatches):
            ap.error(f"--global-batch {args.global_batch} does not split into {d} data shards x "
                     f"{args.microbatches} microbatches")
        run_ranks(args, args.device)
        return
    train(args, device=resolve_device(args.device))


if __name__ == "__main__":
    main()

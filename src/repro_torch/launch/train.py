"""Training launcher: the supervised, checkpointed LM training loop on one
device. Counterpart of `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b --smoke --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b --global-batch 2 --seq 4096 --steps 6

Runs on ``cuda`` unless ``--device cpu``; with no card and no ``--device
cpu`` it raises. ``--smoke`` takes the arch's reduced config (float32);
without it the published config in bfloat16, parameters made on the device
from seed 0, AdamW moments in float32. Batches come from the synthetic
pipeline (`repro_torch.data`). Prints the losses, then ms a step (the
median over the steps after the first), tokens/s, peak device memory and
the model's TFLOP/s, ``4 * forward_flops / step time`` (the reference's
train convention, `launch.flops`). ``--mesh`` is not ported yet.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import DataConfig, global_batch_at
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import Supervisor
from repro_torch.launch.flops import forward_flops
from repro_torch.optim import AdamWConfig, ScheduleConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step


class StepClock:
    """Marks the start and end of each step: CUDA events on a card, the
    host clock on the CPU. Read ``ms()`` after the run."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks: list[tuple] = []

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wrap(self, fn):
        def timed(*args):
            start = self._mark()
            out = fn(*args)
            self.marks.append((start, self._mark()))
            return out
        return timed

    def ms(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


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


def main(argv=None) -> None:
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
    ap.add_argument("--mesh", default=None, help="a (data, model) mesh such as 2x2: not ported yet")
    ap.add_argument("--device", default=None, help="cuda (default; must exist) or cpu")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh needs the LM's sharding rules, which are not ported yet "
                                  "(ROADMAP queue A, the LM's distributed pieces, A13c)")

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch, dtype=torch.bfloat16)
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=args.global_batch, seq_len=args.seq)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=args.lr),
                       schedule=ScheduleConfig(warmup_steps=10, total_steps=args.steps),
                       microbatches=args.microbatches)

    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(gen, cfg, device=device)
    step = make_train_step(cfg, tcfg)
    clock = StepClock(device)
    timed = clock.wrap(step)

    def step_fn(st, i):
        return timed(st, global_batch_at(i, data, device=device))

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sup = Supervisor(step_fn, CheckpointManager(args.ckpt_dir, keep=3), save_every=args.save_every)
    t0 = time.perf_counter()
    sup.run(state, args.steps)
    losses = [float(m["loss"]) for m in sup.metrics_log]
    wall = time.perf_counter() - t0

    print(summary(cfg, losses, clock.ms(), args.global_batch, args.seq, device))
    print(f"wall {wall:.1f} s for {len(losses)} steps and the checkpoint saves (every {args.save_every} steps and "
          f"at the last, to {args.ckpt_dir}); restarts {sup.restarts}")


if __name__ == "__main__":
    main()

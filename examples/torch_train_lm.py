"""End-to-end LM training on PyTorch: trains the reduced config of any of
the ten architectures on the synthetic pipeline, with checkpoints and the
fault-tolerant supervisor. Counterpart of examples/train_lm.py.

    PYTHONPATH=src python examples/torch_train_lm.py --arch starcoder2-7b --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --inject-failure 10

Runs on the CUDA device unless ``--device cpu``.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, global_batch_at  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.distributed.fault import FailureInjector, Supervisor  # noqa: E402
from repro_torch.optim import AdamWConfig, ScheduleConfig  # noqa: E402
from repro_torch.train import TrainConfig, init_train_state, make_train_step  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="starcoder2-7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="build/torch_train_ckpt")
    ap.add_argument("--inject-failure", type=int, default=None, help="simulate a node failure at this step")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    print(f"arch={args.arch} (reduced: {cfg.total_layers}L d{cfg.d_model}, {cfg.param_count() / 1e6:.1f}M params) "
          f"on {device}")

    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=args.batch, seq_len=args.seq, seed=0)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=args.lr),
                       schedule=ScheduleConfig(warmup_steps=10, total_steps=args.steps))
    state = init_train_state(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    train_step = make_train_step(cfg, tcfg)

    def make_batch(step):
        batch = global_batch_at(step, data, device=device)
        # the stub frontends' inputs, drawn from the step (CPU generator)
        if cfg.encoder_layers:
            gen = torch.Generator().manual_seed(1_000_000 + step)
            batch["frames"] = torch.randn((args.batch, cfg.encoder_frames, cfg.d_model), generator=gen).to(
                device, cfg.dtype)
        if cfg.prefix_tokens:
            gen = torch.Generator().manual_seed(2_000_000 + step)
            batch["prefix_embeddings"] = torch.randn((args.batch, cfg.prefix_tokens, cfg.d_model),
                                                     generator=gen).to(device, cfg.dtype)
        return batch

    def step_fn(st, i):
        return train_step(st, make_batch(i))

    injector = FailureInjector((args.inject_failure,)) if args.inject_failure else None
    sup = Supervisor(step_fn, CheckpointManager(args.ckpt_dir, keep=2), save_every=25, injector=injector)
    state, _ = sup.run(state, args.steps)

    losses = [float(m["loss"]) for m in sup.metrics_log]
    for i in range(0, len(losses), max(1, len(losses) // 10)):
        print(f"step {sup.metrics_log[i]['step']:5d}  loss {losses[i]:.4f}  "
              f"{'<- straggler' if sup.metrics_log[i]['straggler'] else ''}")
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); restarts={sup.restarts}")
    assert losses[-1] < losses[0], "training did not reduce loss"


if __name__ == "__main__":
    main()

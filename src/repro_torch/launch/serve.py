"""Serving launcher: one block prefill of the prompt, then batched greedy
decode with the KV/state caches. Counterpart of `repro.launch.serve`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b --smoke --device cpu --tokens 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b     # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b --prompt-len 128 --tokens 32 --profile

Runs on ``cuda`` unless ``--device cpu``; with no card and no ``--device
cpu`` it raises. Parameters are made from ``--seed`` on the device, in the
config's dtype (bfloat16 at full width); nothing is downloaded. Prints one
line: prefill ms, decode ms a step, decode tokens/s and peak device memory.
``--profile`` (a card only) then traces decode steps with `torch.profiler`:
device ms a step (the kernels' own time), kernels a step, the device's busy
share of the step and the kernels that take the most time.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, encode, init_decode_state, init_params


class Generation(NamedTuple):
    tokens: torch.Tensor        # (B, n_tokens) greedy tokens, on the host
    logits: torch.Tensor        # (B, V) the last step's logits, on the device
    finite: bool                # every logit of every step finite
    prefill_ms: float           # the block prefill (CUDA events on a card)
    decode_ms: float            # a decode step, the mean of n_tokens - 1


def _mark(device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    b.synchronize()
    return a.elapsed_time(b)


def generate(params, cfg, prompt, n_tokens: int, *, enc_out=None) -> Generation:
    """Greedy generation of ``n_tokens`` for each row of ``prompt`` (B, P):
    one block prefill through `decode_step`, then ``n_tokens - 1`` one-token
    steps. Tokens are fed back as device tensors; the host reads the batch's
    tokens once, at the end."""
    b, p = prompt.shape
    device = prompt.device
    with torch.no_grad():
        state = init_decode_state(cfg, b, p + n_tokens, cfg.dtype, device=device)
        t0 = _mark(device)
        logits, state = decode_step(params, state, prompt, cfg, enc_out=enc_out)
        tok = logits[:, -1:].argmax(-1)
        finite = torch.isfinite(logits).all()
        t1 = _mark(device)
        out = [tok]
        for _ in range(n_tokens - 1):
            logits, state = decode_step(params, state, tok, cfg, enc_out=enc_out)
            tok = logits[:, -1:].argmax(-1)
            finite &= torch.isfinite(logits).all()
            out.append(tok)
        t2 = _mark(device)
        tokens = torch.cat(out, dim=1).cpu()
    return Generation(tokens, logits[:, -1], bool(finite), _elapsed_ms(t0, t1),
                      _elapsed_ms(t1, t2) / max(n_tokens - 1, 1))


def make_inputs(cfg, batch: int, prompt_len: int, *, seed: int, device):
    """Parameters, prompt tokens and (whisper) encoder states made from
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(gen, cfg, device=device)
    enc_out = None
    if cfg.encoder_layers:
        frames = torch.randn((batch, cfg.encoder_frames, cfg.d_model), generator=gen, dtype=cfg.dtype, device=device)
        with torch.no_grad():
            enc_out = encode(params, frames, cfg)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=device)
    return params, prompt, enc_out


def report(arch: str, g: Generation, batch: int, prompt_len: int, n_tokens: int, device) -> str:
    """The run's line; tokens/s counts the decode steps' tokens."""
    tok_s = batch * 1e3 / g.decode_ms if n_tokens > 1 else float("nan")
    if device.type == "cuda":
        where = f"peak {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB on {torch.cuda.get_device_name(device)}"
    else:
        where = "peak memory not measured (cpu)"
    return (f"{arch}: prefill {prompt_len} tokens x {batch} seqs {g.prefill_ms:.2f} ms, decode "
            f"{g.decode_ms:.2f} ms/step, {tok_s:.1f} tokens/s, {where}")


def profile_decode(params, cfg, prompt, n_steps: int, *, enc_out=None, top: int = 6) -> dict:
    """One-token decode steps after a block prefill of ``prompt`` and two
    warm steps, traced with `torch.profiler`: the kernels' device time and
    count a step, and the ``top`` kernels by device time. Needs a card."""
    from torch.profiler import ProfilerActivity, profile

    if prompt.device.type != "cuda":
        raise RuntimeError("--profile reads device time: it needs a CUDA device")
    b, p = prompt.shape
    with torch.no_grad():
        state = init_decode_state(cfg, b, p + n_steps + 3, cfg.dtype, device=prompt.device)
        logits, state = decode_step(params, state, prompt, cfg, enc_out=enc_out)
        tok = logits[:, -1:].argmax(-1)
        for _ in range(2):
            logits, state = decode_step(params, state, tok, cfg, enc_out=enc_out)
            tok = logits[:, -1:].argmax(-1)
        torch.cuda.synchronize(prompt.device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                logits, state = decode_step(params, state, tok, cfg, enc_out=enc_out)
                tok = logits[:, -1:].argmax(-1)
            torch.cuda.synchronize(prompt.device)
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / n_steps,
        "kernels": sum(e.count for e in kernels) / n_steps,
        "top": [(e.key, e.self_device_time_total / 1e3 / n_steps, e.count / n_steps) for e in kernels[:top]],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced (smoke) config, float32")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true", help="trace 8 decode steps: device ms, kernels, busy share")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params, prompt, enc_out = make_inputs(cfg, args.batch, args.prompt_len, seed=args.seed, device=device)
    g = generate(params, cfg, prompt, args.tokens, enc_out=enc_out)
    if not g.finite:
        raise SystemExit(f"{args.arch}: a logit is not finite")
    print(report(args.arch, g, args.batch, args.prompt_len, args.tokens, device))
    print(f"sample output ids[0]: {g.tokens[0][:16].tolist()}")
    if args.profile:
        prof = profile_decode(params, cfg, prompt, 8, enc_out=enc_out)
        print(f"{args.arch} decode profile: {prof['device_ms']:.2f} device ms a step ({prof['kernels']:.0f} kernels), "
              f"busy {100 * prof['device_ms'] / g.decode_ms:.1f}% of the {g.decode_ms:.2f} ms step")
        for name, ms, count in prof["top"]:
            print(f"  {ms:8.3f} ms a step, {count:5.0f} launches  {name[:90]}")


if __name__ == "__main__":
    main()

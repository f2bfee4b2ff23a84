"""Serving example on PyTorch: batched prefill + greedy decode with the
KV/state cache, on the reduced config of any of the ten architectures
(including the SSM/hybrid ones, whose "cache" is recurrent state).
Counterpart of examples/serve_lm.py.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch mixtral-8x22b --tokens 32
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

Runs on the CUDA device unless ``--device cpu``.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import generate, make_inputs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="mixtral-8x22b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params, prompt, enc_out = make_inputs(cfg, args.batch, args.prompt_len, seed=0, device=device)
    print(f"serving {args.arch} (reduced), batch={args.batch} on {device}")
    g = generate(params, cfg, prompt, args.tokens, enc_out=enc_out)
    print(f"prefill {args.prompt_len} tokens: {g.prefill_ms:.1f} ms")
    print(f"decode  {args.tokens} tokens:  {g.decode_ms:.2f} ms/step "
          f"({args.batch * 1e3 / g.decode_ms:.1f} tok/s), every logit finite: {g.finite}")
    print(f"sample output ids[0]: {g.tokens[0][:16].tolist()}")


if __name__ == "__main__":
    main()

"""The port's serving entry points on the CPU: `repro_torch.launch.serve`
runs a smoke config with ``--device cpu`` and raises without a card when no
device is named; the language-model modules import neither JAX nor
`repro`; examples/torch_serve_lm.py runs."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(*args, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_lm_modules_import_neither_jax_nor_repro():
    r = _run("-c", "import sys, repro_torch.models, repro_torch.configs.registry, repro_torch.launch.serve; "
                   "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
                   "print(bad); sys.exit(1 if bad else 0)")
    assert r.returncode == 0, r.stdout + r.stderr


def test_serve_smoke_on_cpu():
    r = _run("-m", "repro_torch.launch.serve", "--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
             "--tokens", "4")
    assert r.returncode == 0, r.stderr
    line = r.stdout.splitlines()[0]
    assert line.startswith("phi3-mini-3.8b: prefill 16 tokens x 4 seqs") and "ms/step" in line and "tokens/s" in line


def test_serve_without_a_card_raises():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    r = _run("-m", "repro_torch.launch.serve", "--arch", "phi3-mini-3.8b", "--smoke", "--tokens", "2")
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr


def test_serve_example_runs_on_cpu():
    r = _run(str(ROOT / "examples" / "torch_serve_lm.py"), "--arch", "jamba-v0.1-52b", "--device", "cpu",
             "--tokens", "4")
    assert r.returncode == 0, r.stderr
    assert "every logit finite: True" in r.stdout

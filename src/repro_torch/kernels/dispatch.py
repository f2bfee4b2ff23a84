"""Logical-op -> backend dispatch for the bin contractions.

Counterpart of `repro.kernels.dispatch`, minimal:

    op                  backends (priority)                         mode
    ------------------  ------------------------------------------  ------------------------
    deposit_fused       cuda_reduced (30) > cuda (20) > torch (10)  deposition="matrix"
    gather_fused        cuda (20) > torch (10)                      gather="matrix"
    deposit_unfused     cuda (20) > torch (10)                      deposition="matrix_unfused"
    bin_gather          cuda (20) > torch (10)                      gather="matrix_unfused"
    segment_accumulate  cuda (20) > torch (10)                      core.matrix_scatter_add

The backend names map one to one from the reference's: ``xla`` ->
``torch``, ``pallas`` -> ``cuda``, ``pallas_reduced`` -> ``cuda_reduced``
(`canonical` applies the map wherever a name is read, `reference_name`
the inverse wherever a spec is written).

``auto`` resolves by the tensor's device: on a CUDA tensor to the top of
the op's ladder (``cuda_reduced`` for the fused deposition, ``cuda`` for
every other op), on a CPU tensor to ``torch``. A forced name resolves to itself, or
to the best backend below it that the op has (``cuda_reduced`` on the
gather runs ``cuda``). A ``cuda`` backend given a CPU tensor runs the
kernel's plain PyTorch version (see the kernel wrappers in `ops.py`).
"""

from __future__ import annotations

import torch

BACKEND_PRIORITY = {"cuda_reduced": 30, "cuda": 20, "torch": 10}

#: reference backend name -> port backend name
REFERENCE_NAMES = {"xla": "torch", "pallas": "cuda", "pallas_reduced": "cuda_reduced"}

_OPS = {
    "deposit_fused": ("cuda_reduced", "cuda", "torch"),
    "gather_fused": ("cuda", "torch"),
    "deposit_unfused": ("cuda", "torch"),
    "bin_gather": ("cuda", "torch"),
    "segment_accumulate": ("cuda", "torch"),
}


def canonical(name: str) -> str:
    """A backend name in the port's vocabulary (reference names mapped)."""
    name = REFERENCE_NAMES.get(name, name)
    if name != "auto" and name not in BACKEND_PRIORITY:
        raise ValueError(
            f"unknown backend {name!r}; known: {sorted(BACKEND_PRIORITY)}, 'auto', "
            f"or a reference name {sorted(REFERENCE_NAMES)}"
        )
    return name


def reference_name(name: str) -> str:
    """A port backend name in the reference's vocabulary (``auto`` stays)."""
    name = canonical(name)
    return next((ref for ref, port in REFERENCE_NAMES.items() if port == name), name)


def ops() -> tuple[str, ...]:
    return tuple(sorted(_OPS))


def resolve(op: str, requested: str, *, device, grid_shape=None) -> str:
    """Resolve ``requested`` ("auto" or a backend name) to the backend that
    runs ``op`` on tensors of ``device``. ``cuda_reduced`` needs the grid
    geometry (its kernel walks whole z-columns)."""
    if op not in _OPS:
        raise KeyError(f"unknown op {op!r}; registered: {ops()}")
    requested = canonical(requested)
    available = [n for n in _OPS[op] if n != "cuda_reduced" or grid_shape is not None]
    if requested == "auto":
        return available[0] if torch.device(device).type == "cuda" else "torch"
    rank = BACKEND_PRIORITY[requested]
    return next(n for n in available if BACKEND_PRIORITY[n] <= rank)


def demote(current: str, *, device, grid_shape=None) -> str | None:
    """The next backend down the priority ladder from what ``current``
    resolves to for the fused deposition, or None at the bottom."""
    effective = resolve("deposit_fused", current, device=device, grid_shape=grid_shape)
    ladder = sorted(BACKEND_PRIORITY, key=BACKEND_PRIORITY.get, reverse=True)
    below = [n for n in ladder if BACKEND_PRIORITY[n] < BACKEND_PRIORITY[effective]]
    return below[0] if below else None

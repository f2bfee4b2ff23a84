"""Hand-written CUDA kernels for the bin contractions, with their wrappers
(`*/ops.py`), launchers (`*/kernel.py`) and plain PyTorch versions
(`*/ref.py`). Sources are in `repro_torch/csrc`; `build.py` compiles them on
first use. Counterpart of `repro.kernels`, whose names the package
re-exports: the dispatcher and each family's wrappers and plain versions.

Each wrapper adds one to its ``LAUNCHES`` entry where it launches its
kernel. A wrapper called while a CUDA graph is being captured records its
launch into the graph instead: the graph's owner takes those counts back
(`launch_counts` before and after the capture, `add_launches` with
``times=-1``) and adds them once for every replay that ran them. An owner
that knows that number only on the device (a functional window, which
reads nothing back) hands it over as a tensor (`add_launches_later`): it
goes into one running total a device, read when the counts are next read.
"""

import torch

from repro_torch.kernels import dispatch  # noqa: F401
from repro_torch.kernels.deposition import ops as _deposition_ops
from repro_torch.kernels.deposition.ops import bin_outer_product, fused_bin_deposit, fused_bin_deposit_reduced  # noqa: F401
from repro_torch.kernels.deposition.ref import (  # noqa: F401
    bin_outer_product_ref,
    fused_bin_deposit_reduced_ref,
    fused_bin_deposit_ref,
)
from repro_torch.kernels.gather import ops as _gather_ops
from repro_torch.kernels.gather.ops import bin_gather, fused_bin_gather  # noqa: F401
from repro_torch.kernels.gather.ref import bin_gather_ref, fused_bin_gather_ref  # noqa: F401
from repro_torch.kernels.scatter_matrix import ops as _scatter_ops
from repro_torch.kernels.scatter_matrix.ops import segment_accumulate  # noqa: F401
from repro_torch.kernels.scatter_matrix.ref import segment_accumulate_ref  # noqa: F401

_TABLES = (_deposition_ops.LAUNCHES, _gather_ops.LAUNCHES, _scatter_ops.LAUNCHES)
_NAMES = tuple(name for table in _TABLES for name in table)
# launches counted on a device and not yet added: one int64 running total
# a device, an entry a wrapper in the order of _NAMES
_PENDING: dict[torch.device, torch.Tensor] = {}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset (first adding what
    `add_launches_later` left on each device: one host read a device)."""
    for device in list(_PENDING):
        add_launches(dict(zip(_NAMES, _PENDING.pop(device).tolist())), 1)
    return {name: n for table in _TABLES for name, n in table.items()}


def reset_launch_counts() -> None:
    _PENDING.clear()
    for table in _TABLES:
        for name in table:
            table[name] = 0


def add_launches(per_call: dict[str, int], times: int) -> None:
    """Add ``times`` x ``per_call[name]`` to each wrapper's count: the
    launches a captured graph makes in ``times`` replays."""
    for table in _TABLES:
        for name in table:
            table[name] += times * per_call.get(name, 0)


def launch_vector(per_call: dict[str, int], device) -> torch.Tensor:
    """``per_call`` on ``device``, in the form `add_launches_later` takes:
    an int64 entry a wrapper."""
    return torch.tensor([per_call.get(name, 0) for name in _NAMES], dtype=torch.int64, device=device)


def add_launches_later(per_call: torch.Tensor, times: torch.Tensor) -> None:
    """`add_launches` with ``times`` a 0-d integer tensor that may still be
    computed on the device and ``per_call`` a `launch_vector` on the same
    device: added on the device into the device's running total, so the
    caller makes no host read and the pending state stays one tensor a
    device however many calls there are. The total is read and added when
    the counts are next read (`launch_counts`)."""
    total = _PENDING.get(per_call.device)
    if total is None:
        total = _PENDING[per_call.device] = torch.zeros_like(per_call)
    total.add_(per_call * times)

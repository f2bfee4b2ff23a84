"""Hand-written CUDA kernels for the fused bin contractions, with their
wrappers (`*/ops.py`), launchers (`*/kernel.py`) and plain PyTorch versions
(`*/ref.py`). Sources are in `repro_torch/csrc`; `build.py` compiles them on
first use."""

from repro_torch.kernels.deposition import ops as _deposition_ops
from repro_torch.kernels.gather import ops as _gather_ops


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {**_deposition_ops.LAUNCHES, **_gather_ops.LAUNCHES}


def reset_launch_counts() -> None:
    for table in (_deposition_ops.LAUNCHES, _gather_ops.LAUNCHES):
        for name in table:
            table[name] = 0

"""Hand-written CUDA kernels for the bin contractions, with their wrappers
(`*/ops.py`), launchers (`*/kernel.py`) and plain PyTorch versions
(`*/ref.py`). Sources are in `repro_torch/csrc`; `build.py` compiles them on
first use.

Each wrapper adds one to its ``LAUNCHES`` entry where it launches its
kernel. A wrapper called while a CUDA graph is being captured records its
launch into the graph instead: the graph's owner takes those counts back
(`launch_counts` before and after the capture, `add_launches` with
``times=-1``) and adds them once for every replay that ran them.
"""

from repro_torch.kernels.deposition import ops as _deposition_ops
from repro_torch.kernels.gather import ops as _gather_ops
from repro_torch.kernels.scatter_matrix import ops as _scatter_ops

_TABLES = (_deposition_ops.LAUNCHES, _gather_ops.LAUNCHES, _scatter_ops.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: n for table in _TABLES for name, n in table.items()}


def reset_launch_counts() -> None:
    for table in _TABLES:
        for name in table:
            table[name] = 0


def add_launches(per_call: dict[str, int], times: int) -> None:
    """Add ``times`` x ``per_call[name]`` to each wrapper's count: the
    launches a captured graph makes in ``times`` replays."""
    for table in _TABLES:
        for name in table:
            table[name] += times * per_call.get(name, 0)

"""Carrying parameter and decode-state trees across as numpy: nested
dicts, tuples and lists of arrays to the port's tensors and back, every
leaf's dtype kept.

The reference's bfloat16 leaves are `ml_dtypes.bfloat16` numpy arrays;
they go through float32, which holds every bfloat16 value exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """The same tree with each numpy array (or anything `np.asarray` takes)
    as a tensor on ``device``, in the array's dtype."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_to_numpy(tree):
    """The same tree with each tensor as a numpy array in its dtype
    (bfloat16 as `ml_dtypes.bfloat16`)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only a bfloat16 leaf needs it

        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()

"""Logical-axis sharding of the language-model stack, and the load-aware
planning of the PIC driver's 2-D domain decomposition. Counterpart of
`repro.distributed.sharding`.

The models name each tensor's dims by logical axes (`constrain`); a
launcher installs a rule table (`use_rules`) that maps each logical name to
mesh axes. A mesh here is a mapping from axis name to size, such as
``{"data": 2, "model": 2}``, and a spec is a plain tuple whose entries are
None, a mesh-axis name or a tuple of names: the port's counterpart of a
`PartitionSpec`, equal to ``tuple(P(...))`` of the reference. Every mesh
axis is held on the one device, as the PIC driver stacks its shards, so a
table places nothing: `constrain` checks its axes against the tensor's
rank and returns the tensor, and a step computes the same function with
rules as without (GSPMD leaves the reference's step the same function).

Logical axes used across the stack:
  batch       global batch                    -> ('pod','data') / ('data',)
  seq         sequence (activations)          -> 'model' (sequence parallel)
  kv_seq      KV-cache sequence               -> shape-strategy dependent
  heads       attention heads                 -> 'model'
  embed       residual stream features        -> usually None (replicated)
  mlp         FFN hidden                      -> 'model'
  experts     MoE expert dim                  -> 'model' (EP)
  vocab       vocabulary                      -> 'model'
  fsdp        parameter sharding dim          -> 'data' (ZeRO-3)
  stack       scan-stacked layer dim          -> None
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from repro_torch.core.shape_functions import max_guard
from repro_torch.distributed.tensor_parallel import splits_model

__all__ = [
    "Rules",
    "constrain",
    "current_rules",
    "decode_rules",
    "is_axes",
    "logical_spec",
    "map_axes",
    "ModelBlocks",
    "model_dim",
    "plan_balanced_split",
    "recompute_context",
    "rules_for",
    "tensor_parallel",
    "train_rules",
    "tree_specs",
    "use_rules",
    "valid_mesh_splits",
]

_state = threading.local()


def valid_mesh_splits(n_devices: int, global_shape, order: int) -> list[tuple[int, int]]:
    """Every (sx, sy) factorization of ``n_devices`` whose local block
    divides the global grid and is at least the deposition guard wide on
    every axis (a halo slab must not wrap into the neighbour's neighbour:
    the check `pic.distributed.validate_shard_guard` makes of the
    configured split). In increasing sx."""
    g = max_guard(order)
    nx, ny, nz = global_shape
    out = []
    for sx in range(1, n_devices + 1):
        if n_devices % sx:
            continue
        sy = n_devices // sx
        if nx % sx or ny % sy:
            continue
        if min(nx // sx, ny // sy, nz) < g:
            continue
        out.append((sx, sy))
    return out


def plan_balanced_split(n_devices: int, global_shape, order: int, pos, alive, *, admits=None):
    """The (sx, sy) split with the fewest live particles on its densest
    shard: ``pos`` (N, 3) global positions, ``alive`` (N,), host arrays.
    Ties go to fewer shard columns along x (less x-migration), then to the
    squarer split. ``admits(sx, sy)``, if given, keeps only the splits it
    accepts (a rank grid must divide the split). Returns ``(sx, sy,
    peak)``; raises if no split is valid."""
    splits = [s for s in valid_mesh_splits(n_devices, global_shape, order) if admits is None or admits(*s)]
    if not splits:
        raise ValueError(f"no valid (sx, sy) split of {n_devices} devices for grid {tuple(global_shape)} at "
                         f"order {order}")
    pos = np.asarray(pos)
    alive = np.asarray(alive)
    x = pos[alive, 0]
    y = pos[alive, 1]
    best = None
    for sx, sy in splits:
        ix = np.clip((x // (global_shape[0] // sx)).astype(int), 0, sx - 1)
        iy = np.clip((y // (global_shape[1] // sy)).astype(int), 0, sy - 1)
        peak = int(np.bincount(ix * sy + iy, minlength=sx * sy).max()) if x.size else 0
        key = (peak, sx, abs(sx - sy))
        if best is None or key < best[0]:
            best = (key, (sx, sy, peak))
    return best[1]


# ------------------------------------------------------------------
# logical-axis rules (the language-model stack)
# ------------------------------------------------------------------


def _mesh_axes(m):
    """One spec entry as `PartitionSpec` stores it: a 1-tuple becomes its
    name, the empty tuple None."""
    if isinstance(m, (tuple, list)):
        m = tuple(m)
        return None if not m else (m[0] if len(m) == 1 else m)
    return m


class Rules:
    """A rule table, logical axis name -> mesh axes (a name, a tuple of
    names or None), and the mesh it serves as ``{axis name: size}``.
    ``model``, a `distributed.tensor_parallel.TensorParallel`, spreads the
    model axis over ranks: the layers then hold and compute this rank's
    block of every dimension the table maps to ``model``."""

    def __init__(self, table: dict, mesh: dict | None = None, model=None):
        self.table = dict(table)
        self.mesh = None if mesh is None else dict(mesh)
        self.model = model

    def spec(self, axes: tuple) -> tuple:
        return tuple(_mesh_axes(self.table.get(ax)) if ax is not None else None for ax in axes)


def current_rules() -> Rules | None:
    """The table this thread installed with `use_rules`, or None."""
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Rules | None):
    """Install ``rules`` for this thread; the previous table comes back on
    exit, also after an exception. Autograd runs a card's backward (and a
    remat region's recompute) on a worker thread of its own, which sees no
    table: a backward that depends on the rules reads them in its forward."""
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def tensor_parallel():
    """The installed table's model axis over ranks (a `TensorParallel`),
    or None: the model axis is then held whole."""
    r = current_rules()
    return None if r is None else r.model


def recompute_context():
    """A ``context_fn`` for `torch.utils.checkpoint`: the forward's rule
    table installed again around the recompute, which on a card runs on
    autograd's worker thread (where no table is installed) and must take
    the forward's path, its collectives included."""
    return contextlib.nullcontext(), use_rules(current_rules())


def logical_spec(axes: tuple) -> tuple | None:
    r = current_rules()
    return r.spec(axes) if r is not None else None


def constrain(x, *axes):
    """The reference's sharding constraint by logical axes. Returns ``x``
    itself: one device holds every shard. With rules installed, more axes
    than ``x`` has dims raise, as `with_sharding_constraint` refuses such a
    spec when it traces."""
    if current_rules() is not None and len(axes) > x.ndim:
        raise ValueError(f"constrain: {len(axes)} logical axes {axes} for a tensor of rank {x.ndim}")
    return x


def is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of names and Nones, the empty
    tuple (a scalar's) included."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def map_axes(fn, tree):
    """``fn`` over the logical-axis tuples of a tree of dicts and tuples."""
    if is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    return tuple(map_axes(fn, t) for t in tree)


def tree_specs(logical_tree, rules: Rules):
    """A tree of logical-axis tuples -> the same tree of specs."""
    return map_axes(rules.spec, logical_tree)


# ------------------------------------------------------------------
# a rank's blocks of the model axis (`Rules.model`)
# ------------------------------------------------------------------


def model_dim(axes: tuple, table: dict) -> int | None:
    """The dimension of a leaf with logical ``axes`` that ``table`` places
    on the ``model`` mesh axis, or None (the leaf is replicated over it)."""
    dims = [i for i, ax in enumerate(axes) if ax is not None and splits_model(table.get(ax))]
    if len(dims) > 1:
        raise ValueError(f"logical axes {axes} place two dimensions on the model axis")
    return dims[0] if dims else None


def _zip_leaves(tree, axes):
    """``(leaf, its axes)`` pairs of a tree and its logical-axes twin, in
    `tree_leaves` order (dict keys sorted)."""
    if is_axes(axes):
        return [(tree, axes)]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _zip_leaves(tree[k], axes[k])]
    return [pair for t, a in zip(tree, axes) for pair in _zip_leaves(t, a)]


def _rebuild(tree, axes, values):
    """``tree``'s structure with its leaves (in `tree_leaves` order) taken
    from the iterator ``values``."""
    if is_axes(axes):
        return next(values)
    if isinstance(tree, dict):
        done = {k: _rebuild(tree[k], axes[k], values) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    return type(tree)(_rebuild(t, a, values) for t, a in zip(tree, axes))


class ModelBlocks:
    """A rank's blocks of a tree over the model ranks of ``rules``
    (``rules.model``): ``axes`` is the tree's logical-axes twin, ``whole``
    the same tree with the whole leaves' shapes (tensors, on ``meta`` as
    well). A leaf that the table places on ``model`` is cut along that
    dimension into `TensorParallel.range`'s block; every other leaf is
    replicated. Leaves are listed in `tree_leaves` order (dict keys
    sorted), as checkpoints name them."""

    def __init__(self, axes, whole, rules: Rules):
        self.axes, self.rules = axes, rules
        pairs = _zip_leaves(whole, axes)
        self.dims = [model_dim(a, rules.table) for _, a in pairs]
        self.shapes = [tuple(t.shape) for t, _ in pairs]

    def block_of(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's block (a view) of leaf ``i``'s whole value."""
        dim = self.dims[i]
        if dim is None:
            return full
        lo, hi = self.rules.model.range(full.shape[dim])
        return full.narrow(dim, lo, hi - lo)

    def cut(self, tree):
        """This rank's block of every leaf of a whole tree, as contiguous
        copies."""
        leaves = [t for t, _ in _zip_leaves(tree, self.axes)]
        blocks = (self.block_of(i, t).clone(memory_format=torch.contiguous_format) for i, t in enumerate(leaves))
        return _rebuild(tree, self.axes, blocks)

    def gather(self, tree):
        """The whole leaves of a tree of this rank's blocks: each cut leaf
        gathered over the model ranks (collective: every model rank calls
        it), every other leaf as it is."""
        leaves = [t for t, _ in _zip_leaves(tree, self.axes)]
        whole = (t if d is None else self.rules.model.gather_dim(t, d, shape[d])
                 for t, d, shape in zip(leaves, self.dims, self.shapes))
        return _rebuild(tree, self.axes, whole)


# ------------------------------------------------------------------
# the rule tables of each run mode
# ------------------------------------------------------------------


def train_rules(multi_pod: bool, *, expert_parallel: bool = True) -> dict:
    """expert_parallel: EP shards MoE experts over 'model' (needs
    n_experts % model_axis == 0); otherwise TP shards the expert FFN width
    (mixtral: 8 experts < 16-way model axis)."""
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "seq": "model",        # sequence-parallel residual stream
        "kv_seq": None,
        "heads": "model",
        "kv_heads": "model",
        "embed": None,
        "mlp": "model",
        "experts": "model" if expert_parallel else None,
        "expert_mlp": None if expert_parallel else "model",
        "vocab": "model",
        "fsdp": batch,         # ZeRO param/optimizer sharding
        "stack": None,
    }


def rules_for(cfg, *, mode: str, multi_pod: bool, data_axis: int = 16, model_axis: int = 16,
              shard_batch: bool = True) -> dict:
    """Arch-aware rule table: a logical axis falls back to replication where
    its dimension does not divide the mesh axis (whisper's 6 heads,
    mixtral's 8 experts, ...); heads stay sharded wherever they are at least
    the axis, evenly or not (starcoder2-7b's 36 heads pad to 48).

    mode: "train" | "decode". For decode, if kv heads cannot shard over
    'model' the KV-cache *sequence* is sharded there instead; with
    ``shard_batch=False`` (batch-1 long-context decode) it is sharded over
    every axis that would have held the batch.
    """
    batch = ("pod", "data") if multi_pod else ("data",)
    div = lambda n, m: (n % m == 0) and n >= m  # noqa: E731

    heads = "model" if cfg.n_heads >= model_axis else None
    kv_heads = "model" if div(cfg.n_kv_heads, model_axis) else None
    ep = cfg.moe is not None and div(cfg.moe.n_experts, model_axis)

    table = {
        "batch": batch if shard_batch else None,
        "seq": "model" if mode == "train" else None,
        "kv_seq": None,
        "heads": heads,
        "kv_heads": kv_heads,
        "embed": None,
        "mlp": "model",
        "experts": "model" if ep else None,
        "expert_mlp": None if (ep or cfg.moe is None) else "model",
        "vocab": "model",  # always worth sharding; pad <= 1 row per shard
        "fsdp": batch,
        "stack": None,
    }
    if mode == "decode":
        if kv_heads is None:
            table["kv_seq"] = "model"
        if not shard_batch:
            table["kv_seq"] = batch + ("model",) if kv_heads is None else batch
    if cfg.name.startswith("whisper"):
        # tiny model: sequence parallelism not worth it / 1500-frame encoder
        table["seq"] = None
    return table


def decode_rules(multi_pod: bool, *, shard_batch: bool = True, expert_parallel: bool = True) -> dict:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch if shard_batch else None,
        "seq": None,
        # batch=1 long-context decode shards the KV sequence instead
        "kv_seq": None if shard_batch else batch,
        "heads": "model",
        "kv_heads": "model",
        "embed": None,
        "mlp": "model",
        "experts": "model" if expert_parallel else None,
        "expert_mlp": None if expert_parallel else "model",
        "vocab": "model",
        "fsdp": batch,
        "stack": None,
    }

"""The distributed pieces over several processes, one process a rank: the
PIC driver's shard mesh (`RankGrid`) and the LM stack's data and pipe axes
(`AxisRanks`).

The one-process driver holds every shard of an ``(SX, SY)`` mesh on one
device, stacked on two leading shard axes (`repro_torch.pic.distributed`).
Over a `torch.distributed` process group each rank holds a contiguous
block of that stack instead: the ranks form a grid ``(PX, PY)`` with
``PX | SX`` and ``PY | SY``, and rank ``r = rx * PY + ry`` holds shards
``[rx * BX, (rx + 1) * BX) x [ry * BY, (ry + 1) * BY)``, ``BX = SX / PX``,
``BY = SY / PY``. With ``PX * PY = SX * SY`` a rank holds one shard, as a
device does under the reference's ``shard_map``.

`RankGrid` carries the grid and the group, and does the stack's collectives
across ranks:

* `RankGrid.ring_shift` is ``torch.roll`` along a shard axis (the
  reference's ``lax.ppermute`` over its ring), with the edge slab swapped
  with the neighbour rank on that axis by ``batch_isend_irecv``; along an
  axis of one rank it stays the local roll;
* `RankGrid.gather` is the full ``[SX, SY, ...]`` tensor of a per-shard
  value, by ``all_gather``: a reduction over the mesh is the stack's own
  ``.sum`` / ``.amax`` of it, so a float total is bit-equal to the
  one-process stack's (``all_reduce`` would add in another order).

Every rank reads the same reductions, so every rank takes the same branch
on the host. The payloads travel as their bytes (``uint8``), so that
neither backend has to know a dtype (gloo takes no ``uint16``).

The rank grid is always the x-first choice of `choose_rank_grid`, on a
re-split too. One process is ``ranks=None`` in the drivers, never a
`RankGrid` of one rank (`make_pic_mesh` returns no grid for a group of
one); a `RankGrid` always runs its collectives, so one built by hand over
a group of one runs the real ones.

The language-model stack spreads one stacked mesh axis over ranks the same
way (`AxisRanks`): the ``data`` axis (shards of the batch: the train step's
gradient reduction, `distributed.compression`) or the ``pipe`` axis (GPipe
stages, `distributed.pipeline`). Rank ``r`` of ``W`` holds the contiguous
block ``[r n / W, (r + 1) n / W)`` of the axis's ``n`` entries. Its
collectives: `AxisRanks.gather` (``all_gather`` into ``[n, ...]``, rank
order), `AxisRanks.reduce_sum_` (a tree of per-rank contributions summed
in rank order from zeros, gathered a bounded chunk at a time),
`AxisRanks.gather_dim` (a leaf's contiguous blocks, `block_range`, along
one dimension into the whole, uneven blocks padded to the widest),
`AxisRanks.reduce_scatter` (`reduce_sum_`'s sum of which the rank keeps
its block: the ``fsdp`` rule's gradient, `distributed.fsdp`),
`AxisRanks.sum_exact` (an ``all_reduce`` of integers, exact in any
order), `AxisRanks.shift` (a one-way shift to the next rank with no wrap,
the reference's ``fwd_perm``) and `AxisRanks.broadcast_last`. Each counts
its calls in ``counts``.

`init_ranks` joins a group through a ``FileStore`` under a directory the
caller names (no network address): NCCL with ``cuda:rank`` on the card,
gloo on the CPU. `check_rank_request` refuses, by name, more ranks than
visible cards and a rank count with no grid that divides the mesh;
`check_rank_grid` refuses a given grid that does not divide it;
`check_axis_request` refuses more ranks than cards and a rank count that
does not divide an LM axis.

The (data, model) layout of the LM stack (`MeshRanks`, built by
`mesh_ranks`) lays D·M ranks out as rank ``r = d M + m``, so that the
ranks of one model group are neighbours: a data group for each ``m``
(ranks ``m, M + m, ...``) and a model group for each ``d`` (ranks ``d M
... d M + M - 1``), each made by ``dist.new_group`` in the same order on
every rank, and an `AxisRanks` for each axis over this rank's group. Its
own collectives (``values``, ``agree``, ``barrier``) run over all D·M
ranks. The model axis's step collectives are `distributed.tensor_parallel`'s,
the data axis's parameter gathers and reduce-scatters `distributed.fsdp`'s.
"""

from __future__ import annotations

import collections
import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves

__all__ = ["AxisRanks", "GATHER_CHUNK_BYTES", "MeshRanks", "RankGrid", "block_range", "check_axis_request",
           "check_rank_grid", "check_rank_request", "choose_rank_grid", "close_ranks", "init_ranks", "mesh_ranks",
           "rank_device", "stack_sum"]

#: the most bytes of one rank's contribution that `AxisRanks.reduce_sum_`
#: gathers at once: its temporaries are ``world`` such chunks and one sum
GATHER_CHUNK_BYTES = 64 << 20


def choose_rank_grid(world: int, sx: int, sy: int) -> tuple[int, int] | None:
    """The rank grid ``(px, py)`` of ``world`` ranks on an ``sx x sy``
    mesh, x first: the largest ``px`` dividing ``sx`` whose ``py = world /
    px`` divides ``sy``. None if there is none."""
    for px in range(min(world, sx), 0, -1):
        if world % px == 0 and sx % px == 0 and sy % (world // px) == 0:
            return px, world // px
    return None


def check_rank_grid(grid, sx: int, sy: int) -> tuple[int, int]:
    """``grid`` as ``(px, py)``, refused unless it divides the mesh."""
    px, py = (int(v) for v in grid)
    if px < 1 or py < 1 or sx % px or sy % py:
        raise ValueError(f"rank grid ({px}, {py}) does not divide the {sx}x{sy} mesh: each rank holds a "
                         f"contiguous block of shards, so px must divide {sx} and py must divide {sy}")
    return px, py


def check_rank_request(world: int, mesh_shape, *, n_cards: int | None = None) -> tuple[int, int]:
    """The x-first rank grid of ``world`` ranks on the mesh ``mesh_shape``,
    or an error naming the cause: more ranks than the ``n_cards`` visible
    cards (one card a rank; None on the CPU), or no grid that divides the
    mesh."""
    sx, sy = (int(v) for v in mesh_shape)
    if world < 1:
        raise ValueError(f"a run needs at least one rank, got {world}")
    if n_cards is not None and world > n_cards:
        raise RuntimeError(f"{world} ranks need {world} cards, one a rank, but {n_cards} are visible")
    found = choose_rank_grid(world, sx, sy)
    if found is None:
        raise ValueError(f"no rank grid of {world} ranks divides the {sx}x{sy} mesh: {world} must split as "
                         f"px * py with px dividing {sx} and py dividing {sy}")
    return found


def check_axis_request(world: int, n: int, *, n_cards: int | None = None, axis: str = "data",
                       model: int = 1) -> int:
    """The block ``n / (world / model)`` each of ``world`` ranks holds along
    an LM mesh axis of ``n`` entries, the ranks laid out as ``world /
    model`` blocks of the axis by ``model`` ranks of the model axis (a
    (data, model) layout of D·M ranks, `MeshRanks`; ``model = 1``: the
    axis alone), or an error naming the cause: more ranks than the
    ``n_cards`` visible cards (one card a rank; None on the CPU), a rank
    count that is not a multiple of the model axis, or one that does not
    divide the axis."""
    if world < 1:
        raise ValueError(f"a run needs at least one rank, got {world}")
    if n_cards is not None and world > n_cards:
        raise RuntimeError(f"{world} ranks need {world} cards, one a rank, but {n_cards} are visible")
    if model < 1 or world % model:
        raise ValueError(f"{world} ranks do not lay out as the {axis} axis by a model axis of {model}: D·M ranks, "
                         f"rank d·{model} + m")
    blocks = world // model
    if n < 1 or n % blocks:
        raise ValueError(f"{blocks} ranks do not divide the {axis} axis of {n}: each rank holds a contiguous block "
                         f"of {n} / {blocks} entries")
    return n // blocks


def rank_device(rank: int, device=None) -> torch.device:
    """A rank's device: ``cuda:rank`` (one card a rank), or the CPU when
    ``device`` names it. The card must be visible."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"a rank runs on a card or on the CPU, not on {device}")
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if rank >= n_cards:
        raise RuntimeError(f"rank {rank} needs card cuda:{rank}, but {n_cards} are visible; pass device='cpu' to "
                           "run the ranks on the CPU")
    return torch.device("cuda", rank)


def init_ranks(rank: int, world: int, store_dir: str, *, device=None, timeout_s: float = 300.0) -> torch.device:
    """Join the process group of ``world`` processes as ``rank``, through a
    ``FileStore`` in ``store_dir`` (one directory a run, shared by its
    ranks): NCCL on ``cuda:rank``, gloo when ``device`` is the CPU.
    Returns the rank's device. A group that cannot form raises; nothing
    runs a smaller world in its place."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(store_dir, "filestore"), world)
    kw = dict(device_id=dev) if dev.type == "cuda" else {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def close_ranks() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, flat."""
    return t.reshape(-1).view(torch.uint8)


class _Collectives:
    """What every rank view of a group shares: its gathers, agreements and
    barrier. A subclass sets ``rank``, ``world``, ``group`` and ``device``."""

    __slots__ = ()

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on all ranks), stacked in rank
        order: ``[world, *t.shape]``."""
        t = t.contiguous()
        out = torch.empty((self.world,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(_wire(out), _wire(t), group=self.group)
        return out

    def values(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's 0-d ``x`` as a ``[world]`` tensor, in rank order."""
        return self._all_gather(x.reshape(1)).reshape(self.world)

    def agree(self, value: int) -> int:
        """Rank 0's ``value`` on every rank: a host decision that could
        differ between ranks (a read of the wall clock, a timed choice)
        made once. One read on the host."""
        return int(self.values(torch.tensor(int(value), dtype=torch.int64, device=self.device))[0])

    def barrier(self) -> None:
        """Return once every rank is here. The host blocks on both
        backends (on NCCL a collective alone would only order the card's
        stream)."""
        if self.device.type == "cuda":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


class RankGrid(_Collectives):
    """A rank grid ``(px, py)`` over a process group: this process's place
    in it (``rank``, the group's rank, row-major over the grid), the
    group's global ranks (``peers``) and the device the rank's tensors live
    on. Compared by identity: it keys captured windows with the
    `DistConfig` that carries it."""

    __slots__ = ("px", "py", "rank", "group", "peers", "device")

    def __init__(self, px: int, py: int, rank: int, group=None, *, peers=None, device=None):
        self.px, self.py, self.rank = int(px), int(py), int(rank)
        if not 0 <= self.rank < self.px * self.py:
            raise ValueError(f"rank {rank} is outside the ({px}, {py}) rank grid")
        self.group = group
        self.peers = tuple(range(self.px * self.py)) if peers is None else tuple(peers)
        self.device = torch.device("cpu") if device is None else torch.device(device)

    @staticmethod
    def of_group(sx: int, sy: int, group) -> "RankGrid":
        """The x-first rank grid of ``group`` on the ``sx x sy`` mesh, on
        the group's device: ``cuda:current`` for NCCL, else the CPU."""
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        px, py = check_rank_request(world, (sx, sy))
        peers = [dist.get_global_rank(group, i) for i in range(world)]
        nccl = dist.get_backend(group) == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
        return RankGrid(px, py, rank, group, peers=peers, device=device)

    def regrid(self, px: int, py: int) -> "RankGrid":
        """The same group on another grid of as many ranks (a re-split)."""
        if px * py != self.world:
            raise ValueError(f"rank grid ({px}, {py}) holds {px * py} ranks, not the group's {self.world}")
        return RankGrid(px, py, self.rank, self.group, peers=self.peers, device=self.device)

    def __repr__(self) -> str:
        return f"RankGrid({self.px}, {self.py}, rank={self.rank})"

    @property
    def world(self) -> int:
        return self.px * self.py

    @property
    def coords(self) -> tuple[int, int]:
        return divmod(self.rank, self.py)

    def count(self, shard_axis: int) -> int:
        """Ranks along a shard axis (0: x, 1: y)."""
        return self.px if shard_axis == 0 else self.py

    def _peer(self, shard_axis: int, step: int) -> int:
        rx, ry = self.coords
        if shard_axis == 0:
            rx = (rx + step) % self.px
        else:
            ry = (ry + step) % self.py
        return self.peers[rx * self.py + ry]

    # -- the collectives ----------------------------------------------------------

    def ring_shift(self, t: torch.Tensor, shard_axis: int, shift: int) -> torch.Tensor:
        """``torch.roll(t, shift, shard_axis)`` over the whole mesh, ``t``
        this rank's block: with ``shift=+1`` shard j receives shard j - 1's
        slab, so the block's first row comes from the previous rank's last;
        ``-1`` the other way."""
        rolled = torch.roll(t, shifts=shift, dims=shard_axis)
        if self.count(shard_axis) == 1:
            return rolled
        if shift not in (1, -1):
            raise ValueError(f"a ring shift across ranks moves one shard, got shift {shift}")
        n = t.shape[shard_axis]
        take, put = (n - 1, 0) if shift > 0 else (0, n - 1)
        send = t.narrow(shard_axis, take, 1).contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, _wire(send), self._peer(shard_axis, shift), self.group),
               dist.P2POp(dist.irecv, _wire(recv), self._peer(shard_axis, -shift), self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        rolled.narrow(shard_axis, put, 1).copy_(recv)
        return rolled

    def gather(self, per_shard: torch.Tensor, first: int = 0) -> torch.Tensor:
        """The full ``[SX, SY, ...]`` tensor of a per-shard value, given this
        rank's ``[BX, BY, ...]`` block (its shard axes at ``first`` and
        ``first + 1``)."""
        x = per_shard.movedim((first, first + 1), (0, 1))
        bx, by, rest = x.shape[0], x.shape[1], tuple(x.shape[2:])
        grid = self._all_gather(x).reshape((self.px, self.py, bx, by) + rest)
        full = grid.transpose(1, 2).reshape((self.px * bx, self.py * by) + rest)
        return full.movedim((0, 1), (first, first + 1))

    def block(self, full: torch.Tensor, first: int = 0) -> torch.Tensor:
        """This rank's block of a full ``[SX, SY, ...]`` tensor (shard axes
        at ``first`` and ``first + 1``), a view."""
        bx, by = full.shape[first] // self.px, full.shape[first + 1] // self.py
        rx, ry = self.coords
        return full.narrow(first, rx * bx, bx).narrow(first + 1, ry * by, by)


def block_range(n: int, world: int, rank: int) -> tuple[int, int]:
    """The contiguous block ``[lo, hi)`` of ``n`` entries that rank
    ``rank`` of ``world`` holds: the first ``n % world`` ranks hold one
    entry more (`torch.tensor_split`'s blocks)."""
    base, extra = divmod(int(n), int(world))
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (1 if rank < extra else 0)


def stack_sum(stacked: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``stacked[0] + stacked[1] + ...`` added one after another onto
    zeros, in ``stacked``'s dtype: the one-process step's order of
    accumulation, which a library sum (whose order depends on the shape
    and the device) would not keep. Into ``out`` where given."""
    if out is None:
        out = torch.zeros(stacked.shape[1:], dtype=stacked.dtype, device=stacked.device)
    else:
        out.zero_()
    for entry in stacked:
        out += entry
    return out


class AxisRanks(_Collectives):
    """Ranks along one stacked mesh axis of the LM stack (``data``: shards
    of the batch; ``pipe``: GPipe stages) over a process group: the axis
    has ``n`` entries, and rank ``rank`` of ``world`` holds the contiguous
    block ``[start, start + n_local)``. ``peers`` are the group's global
    ranks, ``device`` the rank's tensors' device. ``counts`` counts the
    collectives this object issued, by name (``shift_backward`` counts
    `distributed.pipeline`'s exchanges run backwards)."""

    __slots__ = ("axis", "n", "rank", "world", "group", "peers", "device", "counts")

    def __init__(self, axis: str, n: int, rank: int, world: int, group=None, *, peers=None, device=None):
        check_axis_request(world, n, axis=axis)
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is outside a group of {world}")
        self.axis, self.n, self.rank, self.world = str(axis), int(n), int(rank), int(world)
        self.group = group
        self.peers = tuple(range(self.world)) if peers is None else tuple(peers)
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.counts: collections.Counter = collections.Counter()

    @staticmethod
    def of_group(axis: str, n: int, group) -> "AxisRanks":
        """The ranks of ``group`` along an axis of ``n`` entries, on the
        group's device: ``cuda:current`` for NCCL, else the CPU."""
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        peers = [dist.get_global_rank(group, i) for i in range(world)]
        nccl = dist.get_backend(group) == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
        return AxisRanks(axis, n, rank, world, group, peers=peers, device=device)

    def __repr__(self) -> str:
        return f"AxisRanks({self.axis!r}, n={self.n}, rank={self.rank}, world={self.world})"

    @property
    def n_local(self) -> int:
        return self.n // self.world

    @property
    def start(self) -> int:
        return self.rank * self.n_local

    @property
    def is_last(self) -> bool:
        return self.rank == self.world - 1

    def values(self, x: torch.Tensor) -> torch.Tensor:
        self.counts["values"] += 1
        return super().values(x)

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block ``[n_local, ...]`` of a full ``[n, ...]``
        tensor, a view."""
        return full.narrow(0, self.start, self.n_local)

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The full ``[n, ...]`` tensor from every rank's ``[n_local, ...]``
        block, in rank order."""
        self.counts["gather"] += 1
        return self._all_gather(block).reshape((self.n,) + tuple(block.shape[1:]))

    def reduce_sum_(self, tree) -> int:
        """Replace each leaf of ``tree`` (this rank's contribution, one
        shape and dtype on every rank) by the sum of every rank's, added in
        rank order onto zeros in the leaf's dtype (`stack_sum`): the
        one-process sum of the stacked contributions, bit for bit. A leaf
        crosses in chunks of at most `GATHER_CHUNK_BYTES`, so the
        temporaries stay within ``world + 1`` chunks whatever the leaf's
        size. Returns the bytes this rank contributed."""
        sent = 0
        for leaf in tree_leaves(tree):
            if not leaf.is_contiguous():
                raise ValueError("reduce_sum_ sums contiguous leaves in place")
            flat = leaf.view(-1)
            step = max(1, GATHER_CHUNK_BYTES // leaf.element_size())
            for lo in range(0, flat.numel(), step):
                part = flat[lo:lo + step]
                self.counts["reduce_gather"] += 1
                part.copy_(stack_sum(self._all_gather(part)))
            sent += flat.numel() * leaf.element_size()
        return sent

    def gather_dim(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """The whole of an axis of ``n`` entries at ``dim`` from every rank's
        contiguous block of it (`block_range`: the first ``n % world``
        ranks hold one entry more), in rank order and in ``x``'s layout,
        contiguous. Uneven blocks cross padded to the widest. Counted as
        ``gather_dim``."""
        blocks = [block_range(n, self.world, r) for r in range(self.world)]
        widest = blocks[0][1]
        x = x.contiguous()
        if x.shape[dim] != widest:
            pad = x.new_zeros(x.shape[:dim] + (widest,) + x.shape[dim + 1:])
            pad.narrow(dim, 0, x.shape[dim]).copy_(x)
            x = pad
        self.counts["gather_dim"] += 1
        parts = self._all_gather(x)
        if self.world == 1:
            return parts[0]
        return torch.cat([parts[r].narrow(dim, 0, hi - lo) for r, (lo, hi) in enumerate(blocks)], dim=dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """This rank's block (`block_range`) along ``dim`` (of ``n``
        entries) of every rank's ``x`` (one shape on every rank) summed in
        rank order onto zeros: `reduce_sum_`'s sum, gathered a chunk of
        ``x``'s leading dimension of at most `GATHER_CHUNK_BYTES` at a
        time, of which the rank keeps its slice. Contiguous, in ``x``'s
        dtype; each chunk counted as ``reduce_scatter``."""
        x = x.contiguous()
        lo, hi = block_range(n, self.world, self.rank)
        out = torch.empty(x.shape[:dim] + (hi - lo,) + x.shape[dim + 1:], dtype=x.dtype, device=x.device)
        row = max(1, x[0].numel() * x.element_size())
        step = max(1, GATHER_CHUNK_BYTES // row)
        for a in range(0, x.shape[0], step):
            b = min(a + step, x.shape[0])
            self.counts["reduce_scatter"] += 1
            parts = self._all_gather(x[a:b])
            if dim:
                stack_sum(parts.narrow(dim + 1, lo, hi - lo), out=out[a:b])
            elif max(a, lo) < min(b, hi):
                x0, x1 = max(a, lo), min(b, hi)
                stack_sum(parts[:, x0 - a:x1 - a], out=out[x0 - lo:x1 - lo])
        return out

    def sum_exact(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's integer ``t`` summed (``all_reduce``): integers add
        exactly in any order. In place; returns ``t``."""
        if t.dtype.is_floating_point or t.dtype.is_complex:
            raise TypeError(f"sum_exact adds integers, whose sum is exact in any order; got {t.dtype}")
        self.counts["sum_exact"] += 1
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def shift(self, t: torch.Tensor, step: int = 1) -> torch.Tensor:
        """Send ``t`` to rank ``rank + step`` and return what rank ``rank -
        step`` sent, with no wrap: a rank with no such sender gets zeros, a
        rank with no such receiver sends nothing (the reference's
        ``fwd_perm`` of ``(i, i + 1)`` pairs for ``step = 1``). Every rank
        calls it with one shape and dtype."""
        if step not in (1, -1):
            raise ValueError(f"a shift moves one rank, got step {step}")
        self.counts["shift" if step > 0 else "shift_back"] += 1
        send = t.contiguous()
        recv = torch.zeros_like(send)
        dst, src = self.rank + step, self.rank - step
        ops = []
        if 0 <= dst < self.world:
            ops.append(dist.P2POp(dist.isend, _wire(send), self.peers[dst], self.group))
        if 0 <= src < self.world:
            ops.append(dist.P2POp(dist.irecv, _wire(recv), self.peers[src], self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return recv

    def broadcast_last(self, t: torch.Tensor) -> torch.Tensor:
        """The last rank's ``t`` on every rank (``t`` is the buffer, one
        shape and dtype on every rank). In place; returns ``t``."""
        if not t.is_contiguous():
            raise ValueError("broadcast_last fills a contiguous buffer")
        self.counts["broadcast"] += 1
        dist.broadcast(_wire(t), src=self.peers[-1], group=self.group)
        return t


class MeshRanks(_Collectives):
    """A (data, model) layout of ``world = D·M`` ranks over a process
    group: this process is rank ``rank = d M + m`` of it; ``data`` is the
    `AxisRanks` of the data axis (D entries, one a rank, over the data
    group of column ``m``) and ``model`` that of the model axis (M
    entries, over the model group of row ``d``). ``values``, ``agree``
    and ``barrier`` run over every rank of the layout (``group``)."""

    __slots__ = ("data", "model", "rank", "world", "group", "device")

    def __init__(self, data: AxisRanks, model: AxisRanks, group=None):
        self.data, self.model = data, model
        self.world = data.world * model.world
        self.rank = data.rank * model.world + model.rank
        self.group = group
        self.device = data.device

    def __repr__(self) -> str:
        return f"MeshRanks({self.data.world}x{self.model.world}, rank={self.rank})"

    @property
    def shape(self) -> tuple[int, int]:
        return self.data.world, self.model.world


def mesh_ranks(d: int, m: int, members=None) -> MeshRanks | None:
    """The (data, model) layout of ``d x m`` ranks over the global ranks
    ``members`` (default: every rank of the default group, which must then
    hold ``d * m``): member ``i`` is layout rank ``i``. Collective over the
    default group: every process calls it with the same arguments, member
    or not (``dist.new_group`` asks that); a process outside ``members``
    gets None. A group of every rank of the default group is that group: a
    layout over every rank (one rank too) makes no new group for it."""
    world = dist.get_world_size()
    members = list(range(world)) if members is None else [int(r) for r in members]
    if len(members) != d * m:
        raise ValueError(f"a {d}x{m} layout takes {d * m} ranks, not {len(members)}")

    def group_of(ranks):
        return dist.group.WORLD if sorted(ranks) == list(range(world)) else dist.new_group(ranks)

    whole = group_of(members)
    data_groups = [group_of([members[j * m + c] for j in range(d)]) for c in range(m)]
    model_groups = [group_of([members[r * m + j] for j in range(m)]) for r in range(d)]
    me = dist.get_rank()
    if me not in members:
        return None
    i = members.index(me)
    row, col = divmod(i, m)
    return MeshRanks(AxisRanks.of_group("data", d, data_groups[col]), AxisRanks.of_group("model", m, model_groups[row]),
                     whole)
